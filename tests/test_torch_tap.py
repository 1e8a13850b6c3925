"""The gradient-tap kernel's plain version (`ops/tap.py` on a CPU tensor, the
einsum taps of `models/shading.py`) vs the JAX package's, on the CPU.

The kernel on the card taps every (band, cascade) circularly on the full mip
level; the JAX package (and the plain version) taps a slab window of the
v-duplicated table. `test_circular_taps_equal_slab_taps` pins that the two
give the same numbers within the class of tests/test_pallas_tap.py (atol
5e-5: same texels and weights, fp32 sums in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu.models import shading as js

from godotoceanwaves_tpu_torch.models import shading as ts
from godotoceanwaves_tpu_torch.ops import tap
from godotoceanwaves_tpu_torch.ops._build import LAUNCHES


def lod_inputs(seed=4, c=2, r=64, levels=3):
    """The inputs of tests/test_pallas_tap.py:99-110 (the banded LOD scan):
    two cascades at 64^2, three mip levels, four bands from near to far."""
    rng = np.random.RandomState(seed)
    normal = rng.randn(c, 4, r, r).astype(np.float32)
    scales = np.asarray([[1 / 88.0, 1 / 88.0, 1.0, 1.0],
                         [1 / 16.0, 1 / 16.0, 1.0, 0.6]], np.float32)
    b, pb = 4, 256
    x = rng.uniform(-150, 150, (b, pb))
    z0 = np.array([20.0, 60.0, 150.0, 400.0])[:, None]
    z = z0 + rng.uniform(0, 12.0, (b, pb))
    xz = np.stack([x, z], -1).astype(np.float32)
    lev = np.asarray([[0, 0], [0, 1], [1, 2], [3, 2]], np.int32)
    return normal, scales, xz, lev, levels


def jax_lod(normal, scales, xz, lev, levels, **kw):
    pyr = js.normal_gradient_pyramid(jnp.asarray(normal), levels=levels)
    return np.asarray(js.cascade_gradient_lod(pyr, jnp.asarray(scales), jnp.asarray(xz),
                                              jnp.asarray(lev), **kw))


def torch_pyramid(normal, levels):
    return ts.normal_gradient_pyramid(torch.from_numpy(normal), levels=levels)


def test_pyramid_matches_jax():
    normal, *_ = lod_inputs()
    want = js.normal_gradient_pyramid(jnp.asarray(normal), levels=4)
    got = torch_pyramid(normal, 4)
    assert [tuple(p.shape) for p in got] == [tuple(p.shape) for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("slab_crop", [True, False])
def test_plain_lod_taps_match_jax_einsum(slab_crop):
    normal, scales, xz, lev, levels = lod_inputs()
    want = jax_lod(normal, scales, xz, lev, levels, slab_crop=slab_crop)
    got = ts.cascade_gradient_lod(torch_pyramid(normal, levels), torch.from_numpy(scales),
                                  torch.from_numpy(xz), torch.from_numpy(lev),
                                  slab_crop=slab_crop)
    assert got.shape == want.shape == (4, 256, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


def test_wrapper_on_cpu_runs_plain_version():
    normal, scales, xz, lev, levels = lod_inputs(seed=9)
    args = (torch_pyramid(normal, levels), torch.from_numpy(scales), torch.from_numpy(xz),
            torch.from_numpy(lev))
    before = LAUNCHES["tap"]
    got = tap.gradient_lod_tap(*args)
    assert LAUNCHES["tap"] == before            # no kernel on the CPU
    assert torch.equal(got, tap.gradient_lod_tap_reference(*args))
    assert torch.equal(got, ts.cascade_gradient_lod(*args, tap_impl="pallas"))
    want = jax_lod(normal, scales, xz, lev, levels)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_circular_taps_equal_slab_taps(seed):
    """What the kernel computes (circular taps of the full level at every
    band and cascade, slab_crop=False) against the slab-window taps, with
    blends engaged (coarse levels of a small tile) and a skipped band."""
    rng = np.random.RandomState(seed)
    c, r, levels = 3, 128, 4
    normal = rng.randn(c, 4, r, r).astype(np.float32)
    scales = np.asarray([[1 / 88.0, 1 / 88.0, 1.0, 1.0],
                         [1 / 57.0, 1 / 57.0, 0.75, 1.0],
                         [1 / 16.0, 1 / 16.0, 0.0, 0.25]], np.float32)
    b, pb = 6, 300
    x = rng.uniform(-300, 300, (b, pb))
    z = np.array([3.0, 15.0, 40.0, 90.0, 200.0, 700.0])[:, None] + rng.uniform(0, 9.0, (b, pb))
    xz = torch.from_numpy(np.stack([x, z], -1).astype(np.float32))
    lev = torch.from_numpy(np.asarray([[0, 0, 0], [0, 1, 3], [1, 2, 4], [2, 3, 3],
                                       [3, 3, 2], [4, 4, 4]], np.int32))
    pyr = torch_pyramid(normal, levels)
    s = torch.from_numpy(scales)
    circular = ts.cascade_gradient_lod(pyr, s, xz, lev, slab_crop=False)
    slab = ts.cascade_gradient_lod(pyr, s, xz, lev, slab_crop=True)
    assert torch.equal(circular[-1], torch.zeros_like(circular[-1]))   # all skipped
    np.testing.assert_allclose(circular.numpy(), slab.numpy(), rtol=0, atol=5e-5)


def test_slab_tap_matches_jax():
    """`_slab_tap` (einsum form) on the inputs of tests/test_pallas_tap.py's
    slab case: a narrow z range, full-width x."""
    rng = np.random.RandomState(2)
    r, slab, p = 256, 64, 700
    planes = rng.randn(3, r, r).astype(np.float32)
    s = np.asarray([1 / 88.0, 1 / 88.0, 1.0, 1.0], np.float32)
    x = rng.uniform(-200, 200, p)
    z = rng.uniform(50.0, 50.0 + 0.15 * 88.0, p)
    xz = np.stack([x, z], -1).astype(np.float32)
    pad = np.concatenate([planes, planes], axis=1)
    want = js._slab_tap(jnp.asarray(pad), jnp.asarray(s), jnp.asarray(xz), slab)
    got = ts._slab_tap(torch.from_numpy(pad), torch.from_numpy(s), torch.from_numpy(xz), slab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("cubic", [False, True])
def test_wrap_taps_are_the_nonzero_wrap_weights(cubic):
    """The indexed sampler reads exactly the nonzero entries of the dense
    weight rows, bit for bit, including the wrap seam and values of f that
    round onto n."""
    n = 64
    rng = np.random.RandomState(5)
    f = np.concatenate([rng.uniform(-3 * n, 3 * n, 500), [-1e-8, -0.5, n - 1e-5, n - 0.5, 0.0,
                                                          63.99999, -64.0, 127.5]])
    f = torch.from_numpy(f.astype(np.float32))
    dense = ts._wrap_weights(f, n, cubic).float()
    sparse = torch.zeros_like(dense)
    for idx, w in ts._wrap_taps(f, n, cubic):
        sparse[torch.arange(len(f)), idx] += w
    assert torch.equal(sparse, dense)
    want = np.asarray(js._wrap_weights(jnp.asarray(f.numpy()), n, cubic).astype(jnp.float32))
    np.testing.assert_array_equal(dense.numpy(), want)


@pytest.mark.parametrize("cubic", [False, True])
def test_mxu_samplers_match_jax(cubic):
    rng = np.random.RandomState(6)
    planes = rng.randn(3, 32, 32).astype(np.float32)
    uv = rng.uniform(-2.0, 3.0, (40, 7, 2)).astype(np.float32)
    jfn, tfn = ((js.sample_bicubic_mxu, ts.sample_bicubic_mxu) if cubic
                else (js.sample_bilinear_mxu, ts.sample_bilinear_mxu))
    want = np.asarray(jfn(jnp.asarray(planes), jnp.asarray(uv)))
    got = tfn(torch.from_numpy(planes), torch.from_numpy(uv)).numpy()
    assert got.shape == want.shape == (3, 40, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_wrapper_rejects_what_it_does_not_take():
    normal, scales, xz, lev, levels = lod_inputs()
    pyr = torch_pyramid(normal, levels)
    s, x, lv = torch.from_numpy(scales), torch.from_numpy(xz), torch.from_numpy(lev)
    with pytest.raises(TypeError, match="int32"):
        tap.gradient_lod_tap(pyr, s, x, lv.long())
    with pytest.raises(TypeError, match="float32"):
        tap.gradient_lod_tap(pyr, s, x.double(), lv)
    with pytest.raises(ValueError, match="level 1"):
        tap.gradient_lod_tap([pyr[0], pyr[2]], s, x, lv)
    with pytest.raises(ValueError, match=r"\(C, 3, R, R\)"):
        tap.gradient_lod_tap([torch.zeros(2, 4, 64, 64)], s, x, lv)
    with pytest.raises(ValueError, match="band_levels"):
        tap.gradient_lod_tap(pyr, s, x, lv[:2])
    with pytest.raises(ValueError, match="xz_bands"):
        tap.gradient_lod_tap(pyr, s, x[..., :1], lv)
    with pytest.raises(ValueError, match="at least one"):
        tap.gradient_lod_tap([], s, x, lv)
    with pytest.raises(TypeError, match="one dtype"):
        tap.gradient_lod_tap([pyr[0], pyr[1].to(torch.bfloat16), pyr[2]], s, x, lv)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_taps_equal_from_fp32_and_bf16_levels(seed):
    """The kernel reads the caller's levels in place and rounds each texel
    to bf16 as it loads it; the plain version rounds the levels to bf16
    first. Either way the taps see the same bf16 texels, so fp32 levels
    (the renderer's) and their bf16 copies give equal results."""
    normal, scales, xz, lev, levels = lod_inputs(seed=seed)
    pyr = torch_pyramid(normal, levels)
    args = (torch.from_numpy(scales), torch.from_numpy(xz), torch.from_numpy(lev))
    assert pyr[0].dtype == torch.float32
    fp32 = tap.gradient_lod_tap(pyr, *args)
    bf16 = tap.gradient_lod_tap([p.to(torch.bfloat16) for p in pyr], *args)
    assert torch.equal(fp32, bf16)
    assert float(fp32.abs().max()) > 0.1


def test_power_of_two_wrap_is_jnp_mod():
    """csrc/tap.cu wraps a texel coordinate by f - n floor(f / n) where n is a
    power of two, and by fmod (+ n when negative) elsewhere: the two give
    the same fp32 numbers, seam values included."""
    rng = np.random.RandomState(3)
    for n in (8, 64, 1024, 8192):
        f = np.concatenate([rng.uniform(-4 * n, 4 * n, 4000), rng.uniform(-1e6, 1e6, 4000),
                            [-1e-8, -0.5, -n, n, 0.0, -0.0, n - 1e-5, -n + 1e-5, 3 * n - 0.5]])
        f = torch.from_numpy(f.astype(np.float32))
        nf = torch.tensor(float(n))
        wrapped = f - nf * torch.floor(f / nf)
        assert torch.equal(wrapped, ts._fmod_pos(f, n)), n
