"""The port's strip step and its config-5 session vs the JAX package.

On the CPU the port's `strip_cascade_step` runs its plain PyTorch version;
the JAX side runs `pallas_strip.strip_cascade_step` through
`pl.pallas_call(interpret=True)`, as tests/test_pallas_strip.py does. Both
take the same NumPy inputs.

Tolerances, the classes of tests/test_pallas_strip.py: fp32 maps <= 1e-4
relative RMS (displacement, normal), foam <= 1e-4 RMS; 2-byte maps <= 1e-3
relative RMS displacement and <= 2e-3 RMS normal.
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
from godotoceanwaves_tpu.models import dual_wind_swell_cascades as jax_dual_wind_swell
from godotoceanwaves_tpu.models.ocean import _foam_rates as jax_foam_rates
from godotoceanwaves_tpu.ops import pallas_step, pallas_strip

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models.ocean import _foam_rates
from godotoceanwaves_tpu_torch.ops import fused_step, strip_step
from godotoceanwaves_tpu_torch.utils import convert

DT = np.float32(0.1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def assert_maps_close(got, want, two_byte: bool):
    (d, nm, foam), (wd, wn, wfoam) = got, want
    if two_byte:
        assert rel_rms(host(d), host(wd)) <= 1e-3
        assert rms(host(nm), host(wn)) <= 2e-3
    else:
        assert rel_rms(host(d), host(wd)) <= 1e-4
        assert rel_rms(host(nm), host(wn)) <= 1e-4
    assert rms(host(foam), host(wfoam)) <= 1e-4


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_strip_step_matches_jax_strip_kernel(interpret, dtype):
    """One default cascade at N = 256 with seeded foam (the size that
    tests/test_pallas_strip.py runs the JAX strip kernel at)."""
    n = 256
    jp = jax.tree.map(lambda x: x[:1], J.default_cascades())
    state = J.init_state(J.SimConfig(map_size=n), jp)
    state = state.replace(foam=jnp.asarray(
        np.random.default_rng(1).uniform(0.0, 0.5, (1, n, n)).astype(np.float32)))
    grow, decay = jax_foam_rates(jp, DT)
    j_scal = pallas_step.pack_scalars(state.time + DT, jp.tile_length, jp.whitecap, grow, decay)
    jax_dtype, torch_dtype = DTYPES[dtype]
    want = pallas_strip.strip_cascade_step(state.h0, state.h0nc, state.omega, state.foam,
                                           j_scal, map_dtype=jax_dtype)

    ts = convert.state_from_numpy(leaves(state), device="cpu")
    tp = convert.params_from_numpy(leaves(jp), device="cpu")
    grow, decay = _foam_rates(tp, float(DT))
    t_scal = fused_step.pack_scalars(ts.time + float(DT), tp.tile_length, tp.whitecap,
                                     grow, decay)
    got = strip_step.strip_cascade_step(ts.h0, ts.h0nc, ts.omega, ts.foam, t_scal,
                                        map_dtype=torch_dtype)
    assert got[0].dtype == torch_dtype and got[0].shape == (1, 3, n, n)
    assert_maps_close(got, want, two_byte=dtype != "float32")


def test_strip_reference_is_the_plain_chain():
    """strip_cascade_step_reference is the modulate -> fft -> unpack chain of
    fused_step's plain version, at any N."""
    n = 32
    params = T.default_cascades(device="cpu")
    st = T.init_state(T.SimConfig(map_size=n), params)
    grow, decay = _foam_rates(params, 0.1)
    scal = fused_step.pack_scalars(st.time + 0.1, params.tile_length, params.whitecap,
                                   grow, decay)
    args = (st.h0, st.h0nc, st.omega, st.foam, scal)
    for a, b in zip(strip_step.strip_cascade_step_reference(*args, map_dtype=torch.float32),
                    fused_step.fused_cascade_step_reference(*args, map_dtype=torch.float32)):
        assert torch.equal(a, b)


def test_config5_session_matches_jax():
    """The slice as a whole at full size: BASELINE config 5's two cascades
    (wind sea + swell) at 2048^2 with bf16 maps, three `Ocean.update` calls.
    The port takes its strip tier (the plain version on the CPU); the JAX
    package on the CPU takes its staged path."""
    n = 2048
    jo = J.Ocean(params=jax_dual_wind_swell(), map_size=n, map_dtype="bfloat16",
                 updates_per_second=0)
    to = T.Ocean(params=convert.params_from_numpy(leaves(jo.params), device="cpu"), map_size=n,
                 map_dtype="bfloat16", updates_per_second=0, device="cpu")
    assert to.config.step_tier() == "strip"
    for delta in (0.02, 0.02, 0.03):
        jm, tm = jo.update(delta), to.update(delta)
    assert tm.displacement.dtype == torch.bfloat16 and tm.displacement.shape == (2, 3, n, n)
    assert_maps_close((tm.displacement, tm.normal, to.state.foam),
                      (jm.displacement, jm.normal, jo.state.foam), two_byte=True)
    np.testing.assert_array_equal(to.state.time.numpy(), np.asarray(jo.state.time))
