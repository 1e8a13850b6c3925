"""The port's fused step vs the JAX fused kernel (Pallas, interpret mode).

On the CPU the port's wrappers run their plain PyTorch version; the JAX side
runs `pallas_step.fused_cascade_step` / `fused_cascade_multi_step` through
`pl.pallas_call(interpret=True)`, as tests/test_pallas_step.py does. Both
take the same NumPy inputs. One cascade at N = 128.

Tolerances: fp32 maps <= 1e-4 relative RMS (displacement, normal) and foam
<= 1e-4 RMS; 2-byte maps <= 1e-3 relative RMS displacement and <= 2e-3 RMS
normal (the class tests/test_pallas_step.py uses for 2-byte maps).
"""
import dataclasses
import functools
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from godotoceanwaves_tpu import SimConfig as JaxConfig, default_cascades as jax_cascades
from godotoceanwaves_tpu import init_state as jax_init_state
from godotoceanwaves_tpu.models.ocean import _foam_rates as jax_foam_rates
from godotoceanwaves_tpu.ops import pallas_step

from godotoceanwaves_tpu_torch.models.ocean import _foam_rates
from godotoceanwaves_tpu_torch.ops import fused_step
from godotoceanwaves_tpu_torch.utils import convert

N = 128
DT = np.float32(0.1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_maps_close(got, want, two_byte: bool):
    d, nm, foam = got
    wd, wn, wfoam = want
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


@pytest.fixture(scope="module")
def inputs():
    """One default cascade's state at N = 128 with seeded foam, as NumPy."""
    params = jax.tree.map(lambda x: x[:1], jax_cascades())
    state = jax_init_state(JaxConfig(map_size=N), params)
    foam = np.random.default_rng(0).uniform(0.0, 0.5, (1, N, N)).astype(np.float32)
    leaves = {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}
    leaves["foam"] = foam
    return params, leaves


def _scalars(params, leaves, multi: bool):
    """The same scalar rows for both packages, packed by each one's pack_scalars."""
    t = leaves["time"] + DT
    grow, decay = jax_foam_rates(params, jnp.float32(DT))
    jscal = pallas_step.pack_scalars(jnp.asarray(t), params.tile_length, params.whitecap,
                                     grow, decay, dt=DT if multi else None)
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(params, f.name)) for f in dataclasses.fields(params)},
        device="cpu")
    tgrow, tdecay = _foam_rates(tp, torch.tensor(DT))
    tscal = fused_step.pack_scalars(torch.from_numpy(t), tp.tile_length, tp.whitecap,
                                    tgrow, tdecay, dt=torch.tensor(DT) if multi else None)
    return jscal, tscal


def _jax_args(leaves):
    return tuple(jnp.asarray(leaves[k]) for k in ("h0", "h0nc", "omega", "foam"))


def _torch_args(leaves):
    return tuple(torch.from_numpy(leaves[k].copy()) for k in ("h0", "h0nc", "omega", "foam"))


def test_pack_scalars_matches_jax(inputs):
    for multi in (False, True):
        jscal, tscal = _scalars(*inputs, multi)
        assert tscal.shape == (1, 1, fused_step.NUM_SCALARS)
        np.testing.assert_array_equal(tscal.numpy(), np.asarray(jscal))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_step_matches_jax_kernel(inputs, interpret, dtype):
    jdt, tdt = DTYPES[dtype]
    jscal, tscal = _scalars(*inputs, multi=False)
    want = pallas_step.fused_cascade_step(*_jax_args(inputs[1]), jscal, map_dtype=jdt)
    got = fused_step.fused_cascade_step(*_torch_args(inputs[1]), tscal, map_dtype=tdt)
    assert got[0].shape == (1, 3, N, N) and got[1].shape == (1, 4, N, N)
    assert got[0].dtype == tdt and got[2].dtype == torch.float32
    assert_maps_close(got, want, two_byte=dtype != "float32")


def test_fused_multi_step_matches_jax_kernel(inputs, interpret):
    """K = 2 frames: frame k at t0 + k*dt, foam carried across frames."""
    jscal, tscal = _scalars(*inputs, multi=True)
    want = pallas_step.fused_cascade_multi_step(*_jax_args(inputs[1]), jscal, num_frames=2,
                                                map_dtype=jnp.float32)
    got = fused_step.fused_cascade_multi_step(*_torch_args(inputs[1]), tscal, num_frames=2,
                                              map_dtype=torch.float32)
    assert got[0].shape == (1, 2, 3, N, N) and got[1].shape == (1, 2, 4, N, N)
    for k in range(2):
        assert_maps_close((got[0][:, k], got[1][:, k], got[2]),
                          (want[0][:, k], want[1][:, k], want[2]), two_byte=False)


def test_multi_step_frame_k_equals_single_step_at_its_time(inputs):
    """Frame k of the multi-frame wrapper == a single step at t0 + k*dt with
    the foam of frame k-1: bit-equal on the plain path."""
    _, tscal = _scalars(*inputs, multi=True)
    args = _torch_args(inputs[1])
    d, nm, foam = fused_step.fused_cascade_multi_step(*args, tscal, num_frames=3,
                                                      map_dtype=torch.float32)
    f = args[3]
    for k in range(3):
        row = tscal[:, 0]
        single = tscal.clone()
        single[:, 0, fused_step.S_TIME] = row[:, fused_step.S_TIME] + row[:, fused_step.S_DT] * float(k)
        sd, sn, f = fused_step.fused_cascade_step(*args[:3], f, single, map_dtype=torch.float32)
        assert torch.equal(sd, d[:, k]) and torch.equal(sn, nm[:, k])
    assert torch.equal(f, foam)


def test_cpu_tensors_take_the_plain_version(inputs):
    _, tscal = _scalars(*inputs, multi=False)
    args = _torch_args(inputs[1])
    before = fused_step.LAUNCHES
    got = fused_step.fused_cascade_step(*args, tscal, map_dtype=torch.bfloat16)
    want = fused_step.fused_cascade_step_reference(*args, tscal, map_dtype=torch.bfloat16)
    assert fused_step.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_validates_inputs(inputs):
    _, tscal = _scalars(*inputs, multi=False)
    h0, h0nc, omega, foam = _torch_args(inputs[1])
    with pytest.raises(ValueError, match="omega"):
        fused_step.fused_cascade_step(h0, h0nc, omega[:, :-1], foam, tscal)
    with pytest.raises(TypeError, match="foam"):
        fused_step.fused_cascade_step(h0, h0nc, omega, foam.double(), tscal)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step.fused_cascade_step(h0, h0nc, omega.transpose(1, 2), foam, tscal)
    with pytest.raises(TypeError, match="map_dtype"):
        fused_step.fused_cascade_step(h0, h0nc, omega, foam, tscal, map_dtype=torch.int8)


@pytest.mark.parametrize("n", [8, 2048, 96])
def test_kernel_launcher_rejects_sizes_it_does_not_cover(n):
    """Before building anything, the CUDA launcher refuses N outside the
    power-of-two range 16..1024 and names the strip kernel."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    args = (meta(1, 2, n, n), meta(1, 2, n, n), meta(1, n, n), meta(1, n, n), meta(1, 1, 8))
    with pytest.raises(NotImplementedError, match="pallas_strip"):
        fused_step._launch(*args, num_frames=1, map_dtype=torch.float32, multi=False)


def test_import_builds_nothing():
    """Importing the package neither compiles nor loads the CUDA library."""
    code = ("import sys, godotoceanwaves_tpu_torch, godotoceanwaves_tpu_torch.ops.fused_step\n"
            "assert 'godotoceanwaves_tpu_torch.ops._build' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
