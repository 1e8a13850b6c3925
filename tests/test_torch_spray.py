"""The port's spray particles and billboard splat vs the JAX package's, on
the CPU.

Maps come from the JAX package's `Ocean` (3 cascades at 64^2, cascade 0 at
wind 18 m/s, 8 updates) and cross over as NumPy arrays. Particle state
crosses with `utils/convert.spray_state_from_numpy`.

Tolerances: `spray_init` and 8 `spray_step`s with long dts (respawns) at
P = 256: float fields and attributes within rtol 1e-5 / atol 1e-5, the bools
and the int32 `cycle` equal. The JAX side of the particle steps runs
eagerly: under `jax.jit`, XLA's CPU fusion changes the last bits of the
activation sample, and `normal_factor`, which divides (normal.y - 0.92) by
0.07, carries that to ~1e-4 in `scale_factor` (values up to ~13).
`_puff_lobes` bit-equal. `splat_spray` (puff and gaussian, with and
without `custom_z`) within 2e-3 max abs, the 2-byte class (both sides round
the operands of the composite to bf16).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu import Ocean
from godotoceanwaves_tpu.models import shading as jshading, spray as jspray

from godotoceanwaves_tpu_torch.models import shading as tshading, spray as tspray
from godotoceanwaves_tpu_torch.models.ocean import OceanMaps as TMaps
from godotoceanwaves_tpu_torch.utils import convert

P = 256
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SPLAT = 2e-3


@pytest.fixture(scope="module")
def scene():
    o = Ocean(map_size=64, updates_per_second=0)
    o.set_cascade(0, wind_speed=18.0)
    maps = None
    for _ in range(8):
        maps = o.update(1 / 30) or maps
    scales = o.params.map_scales()
    tmaps = convert.maps_from_numpy(np.asarray(maps.displacement), np.asarray(maps.normal),
                                    device="cpu")
    return maps, scales, tmaps, torch.from_numpy(np.array(scales))


def assert_state_close(got: tspray.SprayState, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, err_msg=f.name, **TOL)
        else:
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_spray_init_and_steps_match_jax(scene):
    maps, scales, tmaps, tscales = scene
    jp = jspray.SprayParams(num_particles=P, emitter_extent=40.0)
    tp = tspray.SprayParams(num_particles=P, emitter_extent=40.0)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    jst, tst = jspray.spray_init(jp), tspray.spray_init(tp, device="cpu")
    assert_state_close(tst, jst)
    now, respawned = 0.0, 0
    for _ in range(8):
        now += 1.1                       # long dts: lifetimes end, cycles advance
        jst, jattrs = jspray.spray_step(jp, jst, maps, scales, np.float32(now))
        tst, tattrs = tspray.spray_step(tp, tst, tmaps, tscales, np.float32(now))
        assert_state_close(tst, jst)
        assert set(tattrs) == set(jattrs)
        for key, val in jattrs.items():
            want, got = np.asarray(val), tattrs[key].numpy()
            if want.dtype == np.bool_:
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        respawned = int(tst.cycle.min())
    assert respawned >= 1, "every particle should have respawned at least once"
    assert bool(tst.has_started.any())


def test_spray_state_crosses_and_continues(scene):
    """A JAX state carried across continues in the port like in JAX; the
    ragged grid of a non-square P is kept (JAX spray.py:69-73)."""
    maps, scales, tmaps, tscales = scene
    p = 200                                  # not a square: ragged last row
    jp = jspray.SprayParams(num_particles=p, emitter_extent=30.0, seed=3)
    tp = tspray.SprayParams(num_particles=p, emitter_extent=30.0, seed=3)
    jst = jspray.spray_init(jp)
    jst, _ = jspray.spray_step(jp, jst, maps, scales, np.float32(2.5))
    tst = convert.spray_state_from_numpy(
        {f.name: np.asarray(getattr(jst, f.name)) for f in dataclasses.fields(jst)},
        device="cpu")
    back = convert.spray_state_to_numpy(tst)
    assert back["cycle"].dtype == np.int32 and back["active"].dtype == np.bool_
    jst, _ = jspray.spray_step(jp, jst, maps, scales, np.float32(7.0))
    tst, _ = tspray.spray_step(tp, tst, tmaps, tscales, np.float32(7.0))
    assert_state_close(tst, jst)
    assert float(tst.start_pos[:, 0].max()) > 30.0     # the overshooting row


def test_cycle_wraps_like_int32(scene):
    """idx + cycle * P wraps as int32 in the reference (JAX spray.py:74):
    a cycle near 2^31 / P spawns the same particles in both packages."""
    maps, scales, tmaps, tscales = scene
    jp = jspray.SprayParams(num_particles=P)
    tp = tspray.SprayParams(num_particles=P)
    idx = np.arange(P, dtype=np.int32)
    cycle = np.full(P, 2 ** 31 // P + 5, np.int32)
    want = jspray._spawn(jp, jnp.asarray(idx), jnp.asarray(cycle), jnp.float32(1.0))
    got = tspray._spawn(tp, torch.from_numpy(idx), torch.from_numpy(cycle),
                        torch.tensor(1.0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_spray_activation_requires_foam(scene):
    """With zero foam everywhere no particle activates (gdshader:91)."""
    maps, scales, tmaps, tscales = scene
    quiet = TMaps(displacement=tmaps.displacement, normal=tmaps.normal.clone())
    quiet.normal[:, 3] = 0.0
    params = tspray.SprayParams(num_particles=64, emitter_extent=30.0)
    st = tspray.spray_init(params, device="cpu")
    for t in (1.0, 3.0, 5.0):
        st, attrs = tspray.spray_step(params, st, quiet, tscales, t)
    assert not bool(st.active.any()) and not bool(attrs["visible"].any())


def test_shaping_functions_match_jax():
    xs = np.linspace(0, 1, 201, dtype=np.float32)
    np.testing.assert_allclose(tspray.exp_impulse(torch.from_numpy(xs), 10.0).numpy(),
                               np.asarray(jspray.exp_impulse(jnp.asarray(xs), 10.0)), **TOL)
    rng = np.random.default_rng(2)
    args = [rng.uniform(0, 1, 64).astype(np.float32) for _ in range(4)]
    args[2] = args[2] * 200
    np.testing.assert_allclose(
        tspray.billboard_alpha(*map(torch.from_numpy, args)).numpy(),
        np.asarray(jspray.billboard_alpha(*map(jnp.asarray, args))), **TOL)


def test_puff_lobes_bit_equal():
    got, want = tshading._puff_lobes(), jshading._puff_lobes()
    assert got.dtype == want.dtype and got.shape == (6, 4)
    np.testing.assert_array_equal(got, want)


def splat_inputs(p=P, seed=5):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (72, 128, 3)).astype(np.float32)
    pos = np.stack([rng.uniform(-30, 30, p), rng.uniform(-1, 3, p), rng.uniform(2, 60, p)],
                   -1).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, (p, 3)).astype(np.float32)
    dissolve = rng.uniform(0, 1, p).astype(np.float32)
    visible = rng.uniform(0, 1, p) > 0.2
    custom_z = rng.uniform(0, 1, p).astype(np.float32)
    return img, pos, scale, dissolve, visible, custom_z


@pytest.mark.parametrize("sprite", ["puff", "gaussian"])
@pytest.mark.parametrize("with_custom_z", [False, True])
def test_splat_spray_matches_jax(sprite, with_custom_z):
    img, pos, scale, dissolve, visible, custom_z = splat_inputs()
    kw = dict(camera_pos=(0.0, 5.0, 0.0), pitch_deg=-8.0, yaw_deg=10.0, fov_deg=70.0,
              foam_color=(0.8, 0.7, 0.6), sprite=sprite)
    jfn = jax.jit(functools.partial(jshading.splat_spray, **kw))
    want = np.asarray(jfn(img, pos, scale, dissolve, visible,
                          custom_z=jnp.asarray(custom_z) if with_custom_z else None))
    got = tshading.splat_spray(*map(torch.from_numpy, (img, pos, scale, dissolve, visible)),
                               custom_z=torch.from_numpy(custom_z) if with_custom_z else None,
                               **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want - img).max() > 0.1, "the splat must change the frame"
    err = float(np.abs(got - want).max())
    assert err <= TOL_SPLAT, f"max |delta| {err:.3e}"


def test_splat_spray_composites_only_visible_particles():
    img = torch.zeros((36, 64, 3))
    pos = torch.tensor([[0.0, 0.0, 30.0], [0.0, 0.0, -30.0]])   # in front, behind
    out = tshading.splat_spray(img, pos, torch.ones((2, 3)), torch.ones(2),
                               torch.tensor([True, True]), camera_pos=(0.0, 10.0, 0.0))
    assert float(out.sum()) > 0.0
    out2 = tshading.splat_spray(img, pos, torch.ones((2, 3)), torch.ones(2),
                                torch.tensor([False, False]), camera_pos=(0.0, 10.0, 0.0))
    assert float(out2.sum()) == 0.0


def test_spray_init_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tspray.spray_init(tspray.SprayParams(num_particles=4))
