"""The whole slice: the port's `Ocean` and step functions vs the JAX package.

Parameters and state cross over as NumPy arrays (utils/convert.py), so both
packages compute from identical inputs. The port runs on the CPU; its fused
step there is the kernel's plain version. Tolerances: maps <= 1e-4
relative RMS, foam <= 1e-4 RMS, time equal in fp32 (the multi-frame kernel's
time semantics are compared against the JAX multi-frame kernel, which shares
them).
"""
import dataclasses
import functools

import numpy as np
import jax
import pytest
import torch
from jax.experimental import pallas as pl

import oracle
import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.models import ocean as jocean

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import ocean as tocean
from godotoceanwaves_tpu_torch.utils import convert


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def assert_state_and_maps_close(t_state, t_maps, j_state, j_maps):
    assert rel_rms(t_maps.displacement.float().numpy(),
                   np.asarray(j_maps.displacement, np.float32)) <= 1e-4
    assert rel_rms(t_maps.normal.float().numpy(), np.asarray(j_maps.normal, np.float32)) <= 1e-4
    assert rms(t_state.foam.numpy(), j_state.foam) <= 1e-4
    np.testing.assert_array_equal(t_state.time.numpy(), np.asarray(j_state.time))


def pair(n, **cfg):
    """The same cascades, config and initial state for both packages."""
    jp = J.default_cascades()
    jcfg = J.SimConfig(map_size=n, **cfg)
    jstate = J.init_state(jcfg, jp)
    tcfg = T.SimConfig(map_size=n, **{k: v for k, v in cfg.items() if k != "fft_impl"})
    return (jcfg, jp, jstate), (tcfg, convert.params_from_numpy(leaves(jp), device="cpu"),
                                convert.state_from_numpy(leaves(jstate), device="cpu"))


@pytest.mark.parametrize("stagger", [False, True])
def test_ocean_session_matches_jax(stagger):
    """Six update() calls at a capped rate (skipped frames fold into dt, and
    in stagger mode refresh one pending cascade each), with a set_cascade
    that dirties cascade 1 (dirty-only regeneration) mid-run."""
    n = 64
    jo = J.Ocean(map_size=n, updates_per_second=30.0, stagger=stagger)
    to = T.Ocean(params=convert.params_from_numpy(leaves(jo.params), device="cpu"), map_size=n,
                 updates_per_second=30.0, stagger=stagger, device="cpu")
    deltas = [0.02, 0.05, 0.01, 0.04, 0.03, 0.02]
    for i, delta in enumerate(deltas):
        if i == 3:
            for o in (jo, to):
                o.set_cascade(1, wind_speed=13.0, tile_length=41.0)
        jm, tm = jo.update(delta), to.update(delta)
        assert (jm is None) == (tm is None), f"update {i}: scheduler diverged"
        assert to._pending == jo._pending and to._next_update_time == jo._next_update_time
        assert_state_and_maps_close(to.state, to.maps, jo.state, jo.maps)
    for name in ("h0", "h0nc"):
        assert rel_rms(getattr(to.state, name).numpy(), getattr(jo.state, name)) <= 1e-4
    np.testing.assert_array_equal(to.state.omega.numpy(), np.asarray(jo.state.omega))
    assert not to._dirty.any()


def test_ocean_resize_and_rate_rebase_match_jax():
    jo = J.Ocean(map_size=32, updates_per_second=10.0)
    to = T.Ocean(map_size=32, updates_per_second=10.0, device="cpu")
    for o in (jo, to):
        o.update(0.02)
        o.updates_per_second = 50.0
        o.resize(16)
    assert to._next_update_time == jo._next_update_time
    assert to.maps.displacement.shape == (3, 3, 16, 16)
    jm, tm = jo.update(0.02), to.update(0.02)
    assert_state_and_maps_close(to.state, tm, jo.state, jm)


def test_ocean_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.Ocean(map_size=16)


@pytest.mark.parametrize("make", ["default_cascades", "dual_wind_swell_cascades", "create"])
def test_params_default_to_the_card(make):
    """The params constructors default to device="cuda" and raise without a
    card instead of running on the CPU; device="cpu" is explicit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn = getattr(T.CascadeParams, make) if make == "create" else getattr(T.models, make)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
    assert fn(device="cpu").wind_speed.device.type == "cpu"


def _carry(name):
    """(function, positional arguments, a tensor of its result) of the
    conversion and ray functions, on the JAX package's own values."""
    if name == "camera_rays":
        from godotoceanwaves_tpu_torch.models import geometry
        return geometry.camera_rays, (8, 4, -7.0, 33.0, 65.0), lambda out: out
    if name == "maps_from_numpy":
        d, nm = np.zeros((1, 3, 4, 4), np.float32), np.zeros((1, 4, 4, 4), np.float32)
        return convert.maps_from_numpy, (d, nm), lambda out: out.normal
    jp = J.models.default_cascades()
    if name == "params_from_numpy":
        return convert.params_from_numpy, (leaves(jp),), lambda out: out.wind_speed
    state = J.init_state(J.SimConfig(map_size=16), jp)
    return convert.state_from_numpy, (leaves(state),), lambda out: out.foam


@pytest.mark.parametrize("name", ["params_from_numpy", "state_from_numpy", "maps_from_numpy",
                                  "camera_rays"])
def test_conversions_default_to_the_card(name):
    """The functions that carry the JAX package's parameters, state and maps
    across, and the camera rays, default to device="cuda" and raise without
    a card; device="cpu" is explicit."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fn, args, tensor = _carry(name)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args)
    assert tensor(fn(*args, device="cpu")).device.type == "cpu"


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _one_cascade_pair(n):
    """Cascade 0 only, JAX config on its fused kernel (interpret mode)."""
    (jcfg, jp, js), (tcfg, tp, ts) = pair(n, fft_impl="pallas")
    assert jcfg.use_fused_step()
    one = lambda x: x[:1]
    return ((jcfg, jax.tree.map(one, jp), jax.tree.map(one, js)),
            (tcfg, tp.map(one), dataclasses.replace(ts, **{
                f.name: one(getattr(ts, f.name)) for f in dataclasses.fields(ts)})))


def test_step_frames_fused_matches_jax_kernel(interpret):
    """K = 2 frames through both packages' multi-frame fused paths: every
    frame's maps, final foam, and the final time time + dt*K."""
    (jcfg, jp, js), (tcfg, tp, ts) = _one_cascade_pair(128)
    j_state, j_maps = jocean.step_frames(jcfg, js, jp, 0.05, 2)
    t_state, t_maps = tocean.step_frames(tcfg, ts, tp, 0.05, 2)
    assert t_maps.displacement.shape == (1, 2, 3, 128, 128)
    assert_state_and_maps_close(t_state, t_maps, j_state, j_maps)


def test_multi_step_fused_matches_jax_kernel(interpret):
    (jcfg, jp, js), (tcfg, tp, ts) = _one_cascade_pair(128)
    j_state, j_maps = jocean.multi_step(jcfg, js, jp, 0.05, 2)
    t_state, t_maps = tocean.multi_step(tcfg, ts, tp, 0.05, 2)
    assert t_maps.displacement.shape == (1, 3, 128, 128)
    assert_state_and_maps_close(t_state, t_maps, j_state, j_maps)


@pytest.mark.parametrize("fused", ["auto", "never"])
@pytest.mark.parametrize("fn", ["step_frames", "multi_step", "simulate"])
def test_multi_frame_functions_match_jax_staged(fn, fused):
    """K = 3 frames at 32^2 vs the JAX staged path (which accumulates dt per
    frame; the fused path's t0 + k*dt may differ from it by an fp32 ulp)."""
    (jcfg, jp, js), (tcfg, tp, ts) = pair(32)
    tcfg = dataclasses.replace(tcfg, fused=fused)
    j_state, j_maps = getattr(jocean, fn)(jcfg, js, jp, 0.05, 3)
    t_state, t_maps = getattr(tocean, fn)(tcfg, ts, tp, 0.05, 3)
    assert tuple(t_maps.displacement.shape) == tuple(j_maps.displacement.shape)
    assert rel_rms(t_maps.displacement.numpy(), j_maps.displacement) <= 1e-4
    assert rel_rms(t_maps.normal.numpy(), j_maps.normal) <= 1e-4
    assert rms(t_state.foam.numpy(), j_state.foam) <= 1e-4
    np.testing.assert_allclose(t_state.time.numpy(), np.asarray(j_state.time), rtol=1e-6)


@pytest.mark.parametrize("fused", ["auto", "never"])
def test_step_cascade_and_refresh_match_jax(fused):
    (jcfg, jp, js), (tcfg, tp, ts) = pair(32, map_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, fused=fused)
    j_state, j_maps = jocean.step_cascade(jcfg, js, jp, 0.05, 2)
    t_state, t_maps = tocean.step_cascade(tcfg, ts, tp, 0.05, 2)
    assert t_maps.displacement.dtype == torch.bfloat16
    assert not t_maps.displacement[:2].any()
    d = t_maps.displacement.float().numpy()
    jd = np.asarray(j_maps.displacement, np.float32)
    assert rel_rms(d, jd) <= 1e-3                      # 2-byte map class
    assert rms(t_state.foam.numpy(), j_state.foam) <= 1e-4
    np.testing.assert_array_equal(t_state.time.numpy(), np.asarray(j_state.time))

    j_state2, jd2, jn2 = jocean.refresh_cascades(jcfg, j_state, jp, 0.05, np.array([0, 2]))
    t_state2, td2, tn2 = tocean.refresh_cascades(tcfg, t_state, tp, 0.05, [0, 2])
    assert rel_rms(td2.float().numpy(), np.asarray(jd2, np.float32)) <= 1e-3
    assert rms(tn2.float().numpy(), np.asarray(jn2, np.float32)) <= 2e-3
    assert rms(t_state2.foam.numpy(), j_state2.foam) <= 1e-4


def test_step_matches_oracle_128():
    """One 128^2 step of cascade 0 on the port's default (fused) path vs the
    NumPy transcription of the reference shaders: <= 1e-4 relative RMS."""
    n, dt = 128, 0.1
    cfg = T.SimConfig(map_size=n, map_dtype="float32")
    params = T.default_cascades(device="cpu")
    _, maps = T.step(cfg, T.init_state(cfg, params), params, dt)
    got_d = maps.displacement[0].numpy().transpose(1, 2, 0)
    got_n = maps.normal[0].numpy().transpose(1, 2, 0)

    p0 = params.map(lambda x: x[0])
    u, f_m = float(p0.wind_speed), float(p0.fetch_length) * 1e3
    tile = tuple(float(v) for v in p0.tile_length)
    h0, h0nc = oracle.packed_spectrum(
        n, tuple(int(v) for v in p0.spectrum_seed), tile,
        alpha=float(oracle.jonswap_alpha(u, f_m)),
        w_p=float(oracle.jonswap_peak_angular_frequency(u, f_m)),
        wind_speed=u, angle=np.deg2rad(float(p0.wind_direction)).astype(np.float32),
        depth=cfg.depth, swell=float(p0.swell), detail=float(p0.detail),
        spread=float(p0.spread))
    layers = oracle.modulate(h0, h0nc, tile, cfg.depth, 120.0 + dt)
    out = oracle.reference_fft_chain(layers, oracle.butterfly_factors(n))
    grow = dt * float(p0.foam_amount) * 7.5
    decay = dt * max(0.5, 10.0 - float(p0.foam_amount)) * 1.15
    ref_d, ref_n, _ = oracle.unpack(out, np.zeros((n, n), np.float32),
                                    float(p0.whitecap), grow, decay)
    assert max(rel_rms(got_d, ref_d), rel_rms(got_n, ref_n)) <= 1e-4


def test_convert_round_trip():
    (_, jp, js), (_, tp, ts) = pair(16)
    back = convert.state_to_numpy(ts)
    for name, value in leaves(js).items():
        np.testing.assert_array_equal(back[name], value)
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy({"wind_speed": np.zeros(3, np.float32)})
