"""Robustness of the port: extreme parameter values never produce NaN/Inf
maps. The twin of tests/test_robustness.py (same cases, seed, size and
steps), on the CPU; each case also runs through the JAX package from the
same parameters, and the port's maps agree with it: <= 1e-4 relative RMS
(displacement and normal), foam <= 1e-4 RMS, as tests/test_torch_slice.py
holds the whole slice.
"""
import dataclasses

import numpy as np
import pytest

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.models import stack_cascades as jstack

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.utils import convert

N = 64

EDGE_CASES = {
    "dead_calm": dict(wind_speed=1e-4, foam_amount=0.0),
    "hurricane": dict(wind_speed=80.0, fetch_length=2000.0, foam_amount=10.0),
    "zero_detail": dict(detail=0.0),
    "full_spread": dict(spread=1.0, swell=0.0),
    "max_swell": dict(swell=2.0, spread=0.0),
    "tiny_tile": dict(tile_length=(1.0, 1.0)),
    "huge_tile": dict(tile_length=(4096.0, 4096.0)),
    "anisotropic_tile": dict(tile_length=(16.0, 512.0)),
    "short_fetch": dict(fetch_length=1e-4),
    "zero_whitecap": dict(whitecap=0.0, foam_amount=10.0),
    "negative_wind_dir": dict(wind_direction=-360.0),
}


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def pair(seed, **kw):
    """One cascade with `kw`, as JAX params and the same values as port params."""
    jp = jstack([J.CascadeParams.create(spectrum_seed=seed, **kw)])
    leaves = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    return jp, convert.params_from_numpy(leaves, device="cpu")


def assert_finite(name, state, maps):
    d, nm = maps.displacement.numpy(), maps.normal.numpy()
    assert np.isfinite(d).all(), f"{name}: displacement not finite"
    assert np.isfinite(nm).all(), f"{name}: normal not finite"
    assert 0.0 <= nm[:, 3].min() and nm[:, 3].max() <= 1.0, f"{name}: foam range"


def assert_matches_jax(name, t_state, t_maps, j_state, j_maps):
    assert rel_rms(t_maps.displacement.numpy(), j_maps.displacement) <= 1e-4, name
    assert rel_rms(t_maps.normal.numpy(), j_maps.normal) <= 1e-4, name
    assert rms(t_state.foam.numpy(), j_state.foam) <= 1e-4, name


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_extreme_params_stay_finite(name):
    jp, tp = pair((3, -9), **EDGE_CASES[name])
    jcfg, tcfg = J.SimConfig(map_size=N), T.SimConfig(map_size=N)
    js, ts = J.init_state(jcfg, jp), T.init_state(tcfg, tp)
    assert np.isfinite(ts.h0.numpy()).all(), f"{name}: h0 not finite"
    for _ in range(3):
        js, jm = J.step(jcfg, js, jp, 0.1)
        ts, tm = T.step(tcfg, ts, tp, 0.1)
    assert_finite(name, ts, tm)
    assert_matches_jax(name, ts, tm, js, jm)


def test_large_dt_and_negative_dt():
    jp, tp = pair((1, 2))
    jcfg, tcfg = J.SimConfig(map_size=N), T.SimConfig(map_size=N)
    js, ts = J.init_state(jcfg, jp), T.init_state(tcfg, tp)
    for dt in (1000.0, -0.1):      # a huge frame skip, then a rewind (foam decay inverts)
        js, jm = J.step(jcfg, js, jp, dt)
        ts, tm = T.step(tcfg, ts, tp, dt)
        assert np.isfinite(tm.displacement.numpy()).all(), dt
        assert_matches_jax(f"dt={dt}", ts, tm, js, jm)
