"""The port's shading math vs the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
math is the same fp32 arithmetic in both; transcendental functions (pow,
exp, atan2) may round differently by an ulp, so values agree to 1e-5
(relative to O(1) colors) unless stated.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu.models import shading as js
from godotoceanwaves_tpu.models.ocean import OceanMaps as JMaps

from godotoceanwaves_tpu_torch.models import shading as ts
from godotoceanwaves_tpu_torch.utils import convert

TOL = dict(rtol=1e-5, atol=1e-5)


def unit(rng, shape):
    v = rng.normal(size=shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def shade_inputs(seed=0, h=12, w=16):
    rng = np.random.default_rng(seed)
    grad = rng.normal(0, 0.6, (h, w, 3)).astype(np.float32)
    grad[..., 2] = rng.uniform(0, 1.5, (h, w))
    height = rng.normal(0, 1.0, (h, w)).astype(np.float32)
    view = unit(rng, (h, w))
    view[..., 1] = np.abs(view[..., 1])
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    light = np.asarray([0.3, 0.55, 0.9], np.float32)
    light /= np.linalg.norm(light)
    dist = rng.uniform(1.0, 600.0, (h, w)).astype(np.float32)
    return grad, height, view, light, dist


@pytest.mark.parametrize("kw", [dict(), dict(sky_ambient=False), dict(specular_aa=True),
                                dict(roughness=0.2, normal_strength=0.6,
                                     light_color=(1.0, 0.8, 0.6))],
                         ids=["default", "no-sky-ambient", "specular-aa", "material"])
def test_shade_matches_jax(kw):
    args = shade_inputs()
    want = np.asarray(js.shade(*(jnp.asarray(a) for a in args), **kw))
    got = ts.shade(*(torch.from_numpy(a) for a in args), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_sky_and_environment_match_jax():
    rng = np.random.default_rng(1)
    d = unit(rng, (20, 30))
    light = np.asarray([0.3, 0.55, 0.9], np.float32) / np.float32(np.linalg.norm([0.3, 0.55, 0.9]))
    light = light.astype(np.float32)
    np.testing.assert_allclose(ts.sky_color(torch.from_numpy(d), torch.from_numpy(light)).numpy(),
                               np.asarray(js.sky_color(jnp.asarray(d), jnp.asarray(light))), **TOL)
    rough = rng.uniform(0.0, 1.0, (20, 30)).astype(np.float32)
    np.testing.assert_allclose(
        ts.sky_color_rough(torch.from_numpy(d), torch.from_numpy(light),
                           torch.from_numpy(rough)).numpy(),
        np.asarray(js.sky_color_rough(jnp.asarray(d), jnp.asarray(light), jnp.asarray(rough))),
        **TOL)
    rgb = rng.uniform(0.0, 1.3, (20, 30, 3)).astype(np.float32)
    dist = rng.uniform(0.0, 500.0, (20, 30)).astype(np.float32)
    hits = rng.uniform(size=(20, 30)) < 0.7
    for h in (hits, None):
        want = js.apply_environment(jnp.asarray(rgb), jnp.asarray(dist),
                                    None if h is None else jnp.asarray(h))
        got = ts.apply_environment(torch.from_numpy(rgb), torch.from_numpy(dist),
                                   None if h is None else torch.from_numpy(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sampler", ["gather", "mxu"])
def test_cascade_sums_match_jax(sampler):
    rng = np.random.default_rng(2)
    disp = rng.normal(0, 1.0, (3, 3, 32, 32)).astype(np.float32)
    normal = rng.normal(0, 0.5, (3, 4, 32, 32)).astype(np.float32)
    # the third tile engages the bicubic blend at N = 32 (ppm * 0.1 < 1)
    scales = np.asarray([[1 / 88.0, 1 / 88.0, 1.0, 1.0], [1 / 57.0, 1 / 57.0, 0.75, 1.0],
                         [1 / 2.0, 1 / 2.0, 0.5, 0.25]], np.float32)
    xz = rng.uniform(-100, 100, (9, 11, 2)).astype(np.float32)
    cam = np.asarray([3.0, -4.0], np.float32)
    want_d = js.cascade_displacement(jnp.asarray(disp), jnp.asarray(scales), jnp.asarray(xz),
                                     camera_xz=jnp.asarray(cam), sampler=sampler)
    got_d = ts.cascade_displacement(torch.from_numpy(disp), torch.from_numpy(scales),
                                    torch.from_numpy(xz), camera_xz=torch.from_numpy(cam),
                                    sampler=sampler)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=2e-5)
    want_g = js.cascade_gradient(jnp.asarray(normal), jnp.asarray(scales), jnp.asarray(xz),
                                 sampler=sampler)
    got_g = ts.cascade_gradient(torch.from_numpy(normal), torch.from_numpy(scales),
                                torch.from_numpy(xz), sampler=sampler)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=2e-5)


def test_gradient_band_levels_match_jax():
    rng = np.random.default_rng(3)
    scales = np.asarray([[1 / 88.0, 1 / 88.0, 1.0, 1.0], [1 / 16.0, 1 / 16.0, 1.0, 0.25]],
                        np.float32)
    dist = rng.uniform(2.0, 1500.0, (8, 50)).astype(np.float32)
    hit = rng.uniform(size=(8, 50)) < 0.8
    hit[3] = False
    for bias in (1.0, 2.5):
        want = js.gradient_band_levels(jnp.asarray(dist), jnp.asarray(hit), jnp.asarray(scales),
                                       2e-3, base_res=1024, nlevels=4, bias=bias)
        got = ts.gradient_band_levels(torch.from_numpy(dist), torch.from_numpy(hit),
                                      torch.from_numpy(scales), 2e-3, base_res=1024, nlevels=4,
                                      bias=bias)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got[3] == 4).all()


def test_flat_render_matches_jax():
    rng = np.random.default_rng(4)
    disp = rng.normal(0, 1.0, (2, 3, 32, 32)).astype(np.float32)
    normal = rng.normal(0, 0.4, (2, 4, 32, 32)).astype(np.float32)
    scales = np.asarray([[1 / 88.0, 1 / 88.0, 1.0, 1.0], [1 / 16.0, 1 / 16.0, 0.5, 0.25]],
                        np.float32)
    kw = dict(width=48, height=27, camera_pos=(2.0, 9.0, -3.0), pitch_deg=-8.0, yaw_deg=20.0,
              environment=True)
    jfn = jax.jit(functools.partial(js.render_ocean, **kw))
    want = np.asarray(jfn(JMaps(jnp.asarray(disp), jnp.asarray(normal)), jnp.asarray(scales)))
    got = ts.render_ocean(convert.maps_from_numpy(disp, normal, device="cpu"),
                          torch.from_numpy(scales),
                          **kw).numpy()
    assert got.shape == (27, 48, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("tile", [88.0, 4.0], ids=["blend", "saturated"])
def test_gradient_taps_choose_on_the_device_like_lax_cond(tile):
    """The "mxu" taps' bicubic/bilinear choice (the JAX package's lax.cond)
    is made on the device, on both sides of mix_t = 1 (at 64^2: the 88 m
    tile blends, the 4 m tile saturates), and agrees with JAX's taps at
    the tolerance of test_torch_live.py's field test."""
    rng = np.random.default_rng(5)
    n = 64
    planes = rng.normal(0, 0.5, (3, n, n)).astype(np.float32)
    s = np.asarray([1 / tile, 1 / tile, 1.0, 1.0], np.float32)
    mix_t = min(1.0, n * (1 / tile) * 0.1)
    assert (mix_t >= 1.0) == (tile == 4.0)
    xz = rng.uniform(-60, 60, (5, 9, 2)).astype(np.float32)
    want = js._gradient_tap(jnp.asarray(planes), jnp.asarray(s), jnp.asarray(xz))
    got = ts._gradient_tap(torch.from_numpy(planes), torch.from_numpy(s), torch.from_numpy(xz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the slab-cropped tap: a band whose v extent fits a 32-row window
    band = xz.copy()
    band[..., 1] = rng.uniform(10.0, 10.0 + 20.0 * tile / n, (5, 9))
    pad = np.concatenate([planes, planes], axis=1)
    want = js._slab_tap(jnp.asarray(pad), jnp.asarray(s), jnp.asarray(band), 32)
    got = ts._slab_tap(torch.from_numpy(pad), torch.from_numpy(s), torch.from_numpy(band), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
