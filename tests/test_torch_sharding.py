"""The port's multi-device layer (`parallel/sharding.py`) vs the JAX package.

The JAX package runs on its 8 virtual CPU devices (tests/conftest.py); the
port runs its mesh positions on the CPU, where the row passes are the rows
kernel's plain version. Parameters and state cross over as NumPy arrays
(utils/convert.py). Tolerances: maps and FFTs <= 1e-4 relative RMS, foam
<= 1e-4 RMS, omega and time equal; the render's band window equal and the
assembled frame within 1e-4 (tests/test_sharding.py:173-204).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.parallel import sharding as jsh
import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import geometry
from godotoceanwaves_tpu_torch.ops import fft
from godotoceanwaves_tpu_torch.parallel import sharding as tsh
from godotoceanwaves_tpu_torch.utils import convert

CPU = torch.device("cpu")
N = 64


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / max(1e-24, np.mean(np.abs(ref) ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def cpu_mesh(rows, count=8):
    return tsh.build_mesh([CPU] * count, rows=rows)


@pytest.mark.parametrize("count,rows", [(8, None), (8, 1), (8, 2), (8, 4), (8, 8), (6, None),
                                        (3, None)])
def test_build_mesh_shapes_match_jax(count, rows):
    want = jsh.build_mesh(jax.devices()[:count], rows=rows)
    got = tsh.build_mesh([CPU] * count, rows=rows)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names) == (tsh.PATCH_AXIS, tsh.ROWS_AXIS)
    assert got.devices.shape == want.devices.shape


def test_build_mesh_errors_match_jax():
    with pytest.raises(ValueError, match="not divisible"):
        jsh.build_mesh(jax.devices(), rows=3)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.build_mesh([CPU] * 8, rows=3)


def test_build_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.build_mesh()


def test_exchange_rows_is_the_transpose():
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 2, N, N).astype(np.float32))
    blocks = list(x.chunk(4, dim=-2))
    got = torch.cat(tsh.exchange_rows(blocks), dim=-2)
    assert torch.equal(got, x.transpose(-2, -1))
    with pytest.raises(ValueError, match="tile"):
        tsh.exchange_rows(blocks[:3])


@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("fold", [False, True])
def test_sharded_fft_matches_single_device(rows, fold):
    """Both front ends vs the port's unsharded chain and the JAX package's."""
    rs = np.random.RandomState(rows)
    x = (rs.randn(4, N, N) + 1j * rs.randn(4, N, N)).astype(np.complex64)
    want = np.asarray(J.ops.fft.ifft2_packed(jnp.asarray(x), impl="matmul", fold_sign=fold))
    ref = fft.ifft2_packed(torch.from_numpy(x), fold_sign=fold).numpy()
    assert rel_rms(ref, want) <= 1e-4

    got = torch.cat(tsh.ifft2_packed_sharded(list(torch.from_numpy(x).chunk(rows, dim=-2)),
                                             fold_sign=fold), dim=-2)
    assert got.dtype == torch.complex64 and rel_rms(got.numpy(), want) <= 1e-4
    planes = torch.from_numpy(np.stack([x.real, x.imag], 1))
    got = torch.cat(tsh.ifft2_planes_sharded(list(planes.chunk(rows, dim=-2)), fold_sign=fold),
                    dim=-2).numpy()
    assert rel_rms(got[:, 0] + 1j * got[:, 1], want) <= 1e-4


@pytest.mark.parametrize("y0,rows", [(0, 16), (16, 16), (48, 16), (8, 40)])
def test_row_blocks_equal_rows_of_the_whole_grid(y0, rows):
    """initial_state, modulate and unpack (pre_shifted=False) on a block of
    rows y0 .. y0 + rows - 1 equal those rows of the whole-grid result."""
    from godotoceanwaves_tpu_torch.models.ocean import generate_spectrum_one
    from godotoceanwaves_tpu_torch.ops import modulate, unpack
    cfg = T.SimConfig(map_size=N)
    p = T.default_cascades(device="cpu").map(lambda x: x[0])
    cut = lambda x: x[..., y0:y0 + rows, :]
    full, block = generate_spectrum_one(cfg, p), generate_spectrum_one(cfg, p, y0, rows)
    for a, b in zip(full, block):
        assert torch.equal(b, cut(a))
    h0, h0nc = full
    omega = torch.from_numpy(T.ops.spectra.dispersion_grid_host(N, p.tile_length.numpy(), 20.0))
    t = torch.tensor(121.5)
    layers = modulate.modulate_planes(h0, h0nc, p.tile_length, 20.0, t, omega=omega)
    got = modulate.modulate_planes(cut(h0), cut(h0nc), p.tile_length, 20.0, t, omega=cut(omega),
                                   y_offset=y0)
    assert torch.equal(got, cut(layers))
    foam = torch.rand(N, N, generator=torch.Generator().manual_seed(y0))
    rates = (torch.tensor(0.5), torch.tensor(0.1), torch.tensor(0.2))
    whole = unpack.unpack_planes(layers, foam, *rates, pre_shifted=False)
    part = unpack.unpack_planes(cut(layers), cut(foam), *rates, pre_shifted=False, y_offset=y0)
    for a, b in zip(whole, part):
        assert torch.equal(b, cut(a))


def test_multipatch_params_seeds_match_jax():
    want = jsh.multipatch_params(J.default_cascades(), num_patches=4, seed=9)
    got = tsh.multipatch_params(T.default_cascades(device="cpu"), num_patches=4, seed=9)
    for name, value in leaves(want).items():
        t = getattr(got, name)
        assert tuple(t.shape) == value.shape, name
        np.testing.assert_array_equal(t.numpy(), value, err_msg=name)
    assert got.spectrum_seed.dtype == torch.int32


def jax_and_port(rows, patches, n=N, cascades=3, **cfg):
    """The same (patches, cascades) params on a JAX mesh and a port mesh of
    8 positions: (JAX config, params, mesh), (port config, params, mesh)."""
    jp = jsh.multipatch_params(jax.tree.map(lambda x: x[:cascades], J.default_cascades()),
                               num_patches=patches, seed=3)
    count = patches * rows
    jmesh = jsh.build_mesh(jax.devices()[:count], rows=rows)
    jcfg = J.SimConfig(map_size=n, **cfg)
    tcfg = T.SimConfig(map_size=n, **{k: v for k, v in cfg.items() if k != "fft_impl"})
    return (jcfg, jp, jmesh), (tcfg, convert.params_from_numpy(leaves(jp), device="cpu"),
                               cpu_mesh(rows, count))


def test_sharded_init_matches_jax():
    (jcfg, jp, jmesh), (tcfg, tp, tmesh) = jax_and_port(rows=4, patches=2, fft_impl="matmul")
    want = leaves(jsh.make_multichip_init(jmesh, jcfg)(jp))
    got = tsh.make_multichip_init(tmesh, tcfg)(tp)
    assert len(got.blocks) == 2 and len(got.blocks[0]) == 4
    assert got.blocks[1][3].h0.shape == (1, 3, 2, N // 4, N)
    g = got.gather()
    for name in ("h0", "h0nc"):
        assert getattr(g, name).shape == want[name].shape
        assert rel_rms(getattr(g, name).numpy(), want[name]) <= 1e-4, name
    for name in ("omega", "time", "foam"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), want[name], err_msg=name)


def test_sharded_step_matches_jax_over_four_frames():
    """Mesh (2, 4), N = 64, the JAX step on its matmul tier: every frame's
    maps and foam, from the JAX package's own initial state."""
    (jcfg, jp, jmesh), (tcfg, tp, tmesh) = jax_and_port(rows=4, patches=2, fft_impl="matmul")
    jstate = jsh.make_multichip_init(jmesh, jcfg)(jp)
    tstate = convert.sharded_state_from_numpy(leaves(jstate), tmesh)
    jstep = jsh.make_multichip_step(jmesh, jcfg)
    tstep = tsh.make_multichip_step(tmesh, tcfg)
    for frame in range(4):
        jstate, jmaps = jstep(jstate, jp, jnp.float32(0.05))
        tstate, tmaps = tstep(tstate, tp, 0.05)
        got = tmaps.gather()
        for name in ("displacement", "normal"):
            assert rel_rms(getattr(got, name).numpy(), np.asarray(getattr(jmaps, name))) <= 1e-4, \
                (frame, name)
        assert rms(tstate.gather().foam.numpy(), np.asarray(jstate.foam)) <= 1e-4, frame
    np.testing.assert_array_equal(tstate.gather().time.numpy(), np.asarray(jstate.time))
    assert float(np.asarray(jstate.foam).max()) > 0.0


def test_sharded_step_matches_jax_rows_kernel_interpret(monkeypatch):
    """N = 256 on a (1, 2) mesh: the JAX step routes its shard-local passes
    through the Pallas rows kernel (128-row shards), run in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    from godotoceanwaves_tpu.ops import pallas_fft
    calls = []
    real = pallas_fft.idft_rows_planes_pallas
    monkeypatch.setattr(pallas_fft, "idft_rows_planes_pallas",
                        lambda x, fold_sign=False: (calls.append(x.shape), real(x, fold_sign))[1])
    (jcfg, jp, jmesh), (tcfg, tp, tmesh) = jax_and_port(rows=2, patches=1, n=256, cascades=1,
                                                        fft_impl="pallas")
    jstate = jsh.make_multichip_init(jmesh, jcfg)(jp)
    tstate = convert.sharded_state_from_numpy(leaves(jstate), tmesh)
    jstate, jmaps = jsh.make_multichip_step(jmesh, jcfg)(jstate, jp, jnp.float32(0.02))
    assert calls and all(s[-2:] == (128, 256) for s in calls), calls
    tstate, tmaps = tsh.make_multichip_step(tmesh, tcfg)(tstate, tp, 0.02)
    got = tmaps.gather()
    for name in ("displacement", "normal"):
        assert rel_rms(getattr(got, name).numpy(), np.asarray(getattr(jmaps, name))) <= 1e-4
    assert rms(tstate.gather().foam.numpy(), np.asarray(jstate.foam)) <= 1e-4


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_sharded_step_matches_port_step(rows):
    """Every mesh shape of 8 positions vs the port's unsharded `step`, per
    patch, over 2 frames (rows == 1 is that `step`, on a batch of cascades)."""
    patches = 8 // rows
    cfg = T.SimConfig(map_size=N)
    params = tsh.multipatch_params(T.default_cascades(device="cpu"), patches, seed=5)
    mesh = cpu_mesh(rows)
    state = tsh.make_multichip_init(mesh, cfg)(params)
    step = tsh.make_multichip_step(mesh, cfg)
    for _ in range(2):
        state, maps = step(state, params, 0.05)
    got, got_state = maps.gather(), state.gather()
    for p in range(patches):
        pp = params.map(lambda x: x[p])
        ref_state = T.init_state(cfg, pp)
        for _ in range(2):
            ref_state, ref = T.step(cfg, ref_state, pp, 0.05)
        assert rel_rms(got.displacement[p].numpy(), ref.displacement.numpy()) <= 1e-4
        assert rel_rms(got.normal[p].numpy(), ref.normal.numpy()) <= 1e-4
        assert rms(got_state.foam[p].numpy(), ref_state.foam.numpy()) <= 1e-4
        assert torch.equal(got_state.time[p], ref_state.time)


def test_gather_of_the_first_patch_positions():
    """A `Sharded` of the first patch positions' blocks alone gathers those
    patches (how a caller takes patch 0 of a sharded state)."""
    cfg = T.SimConfig(map_size=N)
    params = tsh.multipatch_params(T.default_cascades(device="cpu"), 4, seed=2)
    state = tsh.make_multichip_init(cpu_mesh(2), cfg)(params)
    part = tsh.Sharded(state.mesh, state.blocks[:1]).gather()
    whole = state.gather()
    assert part.h0.shape == (1, 3, 2, N, N)
    for f in dataclasses.fields(whole):
        assert torch.equal(getattr(part, f.name), getattr(whole, f.name)[:1]), f.name


def test_sharded_step_keeps_the_map_dtype_and_rejects_bad_shapes():
    cfg = T.SimConfig(map_size=N, map_dtype="bfloat16")
    params = tsh.multipatch_params(T.default_cascades(device="cpu"), 2, seed=1)
    mesh = cpu_mesh(4)
    state = tsh.make_multichip_init(mesh, cfg)(params)
    _, maps = tsh.make_multichip_step(mesh, cfg)(state, params, 0.02)
    assert maps.blocks[0][0].displacement.dtype == torch.bfloat16
    assert maps.blocks[1][3].normal.shape == (1, 3, 4, N // 4, N)
    with pytest.raises(ValueError, match="divisible"):
        tsh.make_multichip_step(cpu_mesh(8, count=8), T.SimConfig(map_size=4))
    with pytest.raises(ValueError, match="divisible"):
        tsh.make_multichip_init(cpu_mesh(1), cfg)(
            tsh.multipatch_params(T.default_cascades(device="cpu"), 3))


def render_inputs():
    cfg = T.SimConfig(map_size=N)
    params = T.default_cascades(device="cpu")
    _, maps = T.step(cfg, T.init_state(cfg, params), params, 0.02)
    kw = dict(quality="low", width=64, camera_pos=(0.0, 6.0, 0.0), pitch_deg=-10.0,
              yaw_deg=15.0, sampler="gather", gradient_lod=False, march_steps=12,
              bisect_steps=3)
    return maps, params.map_scales(), kw


def test_render_band_is_exact_and_the_frame_assembles():
    maps, scales, kw = render_inputs()
    dense = geometry.render_ocean_geometry(maps, scales, height=64, **kw)
    band = geometry.render_ocean_geometry(maps, scales, height=64, rows=(8, 8), **kw)
    assert torch.equal(band, dense[8:16])
    got = tsh.render_geometry_sharded(cpu_mesh(4), maps, scales, height=64, **kw)
    assert got.shape == dense.shape == (64, 64, 3)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-4)
    rows_only = tsh.render_geometry_sharded(cpu_mesh(2), maps, scales, "rows", height=64, **kw)
    np.testing.assert_allclose(rows_only.numpy(), dense.numpy(), atol=1e-4)


def test_render_rejects_indivisible_height():
    with pytest.raises(ValueError, match="not divisible"):
        tsh.render_geometry_sharded(cpu_mesh(4), None, None, height=63)
