"""The heightfield-march kernel's plain version (`ops/march.py` on a CPU
tensor) vs the JAX package's Pallas kernel in interpret mode, on the CPU.

One 2048-pixel tile (the TPU kernel's TILE_P) of rays over a G = 64 table.
The plain version is a transliteration with the same numbers (bf16 table and
z weights, fp32 x weights, two-term fp32 sums, which no order changes), so
`found` must be equal and the brackets within rel 1e-5 where found.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu.models import geometry as jg
from godotoceanwaves_tpu.ops.pallas_march import march_heightfield as jax_march

from godotoceanwaves_tpu_torch.models import geometry as tg
from godotoceanwaves_tpu_torch.ops import march

G = 64
ORIGIN, CELL = -256.0, 512.0 / (G - 1)


def march_inputs(seed=0):
    """A rough random heightfield (+-2 m) and a 64 x 32 frame of rays from
    3 m up, pitched down 12 degrees, windows from a box clip of the table."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(0.0, 1.2, (G // 4, G // 4))
    table = np.kron(coarse, np.ones((4, 4))) + rng.normal(0.0, 0.3, (G, G))
    table = table.astype(np.float32)
    cam = np.asarray([1.3, 3.0, -2.7], np.float32)
    center = np.ceil(cam[[0, 2]]).astype(np.float32)
    d = np.asarray(jg.camera_rays(64, 32, -12.0, 25.0, 70.0)).reshape(-1, 3)
    t0 = rng.uniform(0.0, 0.5, len(d)).astype(np.float32)
    t1 = rng.uniform(150.0, 400.0, len(d)).astype(np.float32)
    valid = rng.uniform(size=len(d)) < 0.9
    return table, d.astype(np.float32), t0, t1, valid, cam, center


@pytest.mark.parametrize("steps,rounds", [(24, 2), (32, 2), (16, 3)])
def test_plain_march_matches_jax_interpret(steps, rounds):
    table, d, t0, t1, valid, cam, center = march_inputs(steps)
    jf, jlo, jhi = jax_march(jnp.asarray(table), jnp.asarray(d), jnp.asarray(t0),
                             jnp.asarray(t1), jnp.asarray(valid), jnp.asarray(cam),
                             jnp.asarray(center), origin=ORIGIN, cell=CELL,
                             march_steps=steps, refine_rounds=rounds, interpret=True)
    tf, tlo, thi = march.march_heightfield(
        torch.from_numpy(table), torch.from_numpy(d), torch.from_numpy(t0),
        torch.from_numpy(t1), torch.from_numpy(valid), torch.from_numpy(cam),
        torch.from_numpy(center), ORIGIN, CELL, march_steps=steps, refine_rounds=rounds)
    jf, jlo, jhi = np.asarray(jf), np.asarray(jlo), np.asarray(jhi)
    assert tf.dtype == torch.bool and tf.shape == (2048,)
    np.testing.assert_array_equal(tf.numpy(), jf)
    assert 0.2 < jf.mean() < 0.95, "the case must hold hits and misses"
    np.testing.assert_allclose(tlo.numpy()[jf], jlo[jf], rtol=1e-5, atol=0)
    np.testing.assert_allclose(thi.numpy()[jf], jhi[jf], rtol=1e-5, atol=0)


def grouped_march(table16, bx, bz, dy, t0, t1, valid, ax, az, cy, *, march_steps: int,
                  refine_rounds: int, group: int = 8):
    """A torch model of csrc/march.cu's control flow: a round's samples in
    groups of `group`, every sample of a group evaluated, the group's first
    crossing taken, and a pixel's round stopped between groups."""
    g = table16.shape[0]
    flat = table16.reshape(-1)
    hi_cap = float(np.float32(g) - np.float32(1.001))
    below = lambda t: march._below(flat, g, hi_cap, ax, az, cy, bx, bz, dy, t)

    def run_round(lo, hi, m, ok):
        seg = (hi - lo) * march._f32(1.0 / m)
        done, new_lo, new_hi = ~ok, lo, hi
        for k0 in range(0, m, group):
            hits = torch.stack([below(lo + (k0 + q + 1.0) * seg) if k0 + q < m
                                else torch.zeros_like(ok) for q in range(group)])
            first = torch.argmax(hits.to(torch.int32), dim=0)
            t = lo + (k0 + first + 1).float() * seg
            now = hits.any(dim=0) & ~done
            new_lo, new_hi = torch.where(now, t - seg, new_lo), torch.where(now, t, new_hi)
            done = done | now
        return done & ok, new_lo, new_hi

    b0 = below(t0) & valid
    hit, lo, hi = run_round(t0, t1, march_steps, valid & ~b0)
    seg0 = (t1 - t0) * march._f32(1.0 / march_steps)
    lo = torch.where(b0, t0, lo)
    hi = torch.where(b0, t0 + seg0, hi)
    found = hit | b0
    for _ in range(refine_rounds):
        _, lo, hi = run_round(lo, hi, 8, found)
    return found, lo, hi


@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("steps,rounds", [(24, 2), (32, 2), (16, 3), (20, 1)])
def test_grouped_first_crossing_equals_serial_march(steps, rounds, group):
    """Groups of samples (csrc/march.cu's 4; the TPU kernel's 8) give the
    serial march's first crossing bit for bit (march_steps a multiple of the
    group or not)."""
    table, d, t0, t1, valid, cam, center = (torch.from_numpy(a) for a in march_inputs(steps))
    table16, lanes, scal = march._lanes(table, d, t0, t1, valid, cam, center, ORIGIN, CELL)
    run = dict(march_steps=steps, refine_rounds=rounds)
    want = march.march_reference(table16, *lanes, *scal, **run)
    got = grouped_march(table16, *lanes, *scal, **run, group=group)
    assert 0.2 < float(want[0].float().mean()) < 0.95
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_plain_march_keeps_frame_shape():
    table, d, t0, t1, valid, cam, center = march_inputs(3)
    args = [torch.from_numpy(a) for a in (table, d, t0, t1, valid, cam, center)]
    flat = march.march_heightfield(*args, ORIGIN, CELL, march_steps=16)
    framed = march.march_heightfield(args[0], args[1].reshape(32, 64, 3),
                                     *(a.reshape(32, 64) for a in args[2:5]), *args[5:],
                                     ORIGIN, CELL, march_steps=16)
    before = march.LAUNCHES
    for a, b in zip(flat, framed):
        assert b.shape == (32, 64)
        assert torch.equal(a.reshape(32, 64), b)
    assert march.LAUNCHES == before


def test_render_pallas_march_matches_xla_bracket():
    """The march kernel route (its plain version here) against the renderer's
    per-pixel bracket rounds, as tests/test_geometry.py pins the JAX pair."""
    rng = np.random.default_rng(11)
    from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
    n = 64
    maps = OceanMaps(displacement=torch.from_numpy(rng.normal(0, 0.8, (2, 3, n, n)).astype(
                         np.float32)).to(torch.bfloat16),
                     normal=torch.from_numpy(rng.normal(0, 0.3, (2, 4, n, n)).astype(
                         np.float32)).to(torch.bfloat16))
    scales = torch.tensor([[1 / 88.0, 1 / 88.0, 1.0, 1.0], [1 / 16.0, 1 / 16.0, 0.5, 0.25]])
    kw = dict(width=96, height=48, camera_pos=(0.0, 2.5, 0.0), pitch_deg=-3.0,
              march_steps=24, bisect_steps=6, sampler="mxu")
    pal = tg.render_ocean_geometry(maps, scales, "low", march_impl="pallas", **kw)
    xla = tg.render_ocean_geometry(maps, scales, "low", march_impl="xla", **kw)
    assert float((pal - xla).abs().mean()) < 5e-3
    hp = tg.render_ocean_geometry(maps, scales, "low", march_impl="pallas",
                                  _debug_stage="march", **kw)[..., 1]
    hx = tg.render_ocean_geometry(maps, scales, "low", march_impl="xla",
                                  _debug_stage="march", **kw)[..., 1]
    assert float((hp != hx).float().mean()) < 0.01


def test_wrapper_rejects_what_it_does_not_take():
    table, d, t0, t1, valid, cam, center = (torch.from_numpy(a) for a in march_inputs())
    run = lambda *a, **k: march.march_heightfield(*a, ORIGIN, CELL, **k)
    with pytest.raises(ValueError, match=r"\(G, G\)"):
        run(table[None], d, t0, t1, valid, cam, center)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        run(table.double(), d, t0, t1, valid, cam, center)
    with pytest.raises(TypeError, match="bool"):
        run(table, d, t0, t1, valid.float(), cam, center)
    with pytest.raises(ValueError, match="dirs"):
        run(table, d[:-1], t0, t1, valid, cam, center)
    with pytest.raises(ValueError, match="t1"):
        run(table, d, t0, t1[:-1], valid, cam, center)
    with pytest.raises(TypeError, match="float32"):
        run(table, d, t0.double(), t1, valid, cam, center)
    with pytest.raises(ValueError, match="march_steps"):
        run(table, d, t0, t1, valid, cam, center, march_steps=0)
    with pytest.raises(ValueError, match=r"cam must be \(3,\)"):
        run(table, d, t0, t1, valid, cam[:2], center)
