"""The port's planes IFFT and its staged session vs the JAX package.

On the CPU `planes_fft.ifft2_packed_planes` runs its plain version
(`fft.ifft2_packed_planes`, torch.fft); the JAX side runs
`pallas_fft.ifft2_packed_planes_pallas` through
`pl.pallas_call(interpret=True)`, as tests/test_pallas_fft.py does. Both take
the same NumPy planes. Tolerance: 1e-4 relative RMS (the class of
tests/test_pallas_fft.py); foam 1e-4 RMS.
"""
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.models import ocean as jocean
from godotoceanwaves_tpu.ops import pallas_fft

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import ocean as tocean
from godotoceanwaves_tpu_torch.ops import planes_fft
from godotoceanwaves_tpu_torch.utils import convert


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("fold_sign", [False, True])
def test_planes_fft_matches_jax_pallas(interpret, n, fold_sign):
    x = np.random.default_rng(n).standard_normal((3, 2, n, n)).astype(np.float32)
    want = np.asarray(pallas_fft.ifft2_packed_planes_pallas(jnp.asarray(x), fold_sign=fold_sign))
    got = planes_fft.ifft2_packed_planes(torch.from_numpy(x), fold_sign=fold_sign)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert rel_rms(got.numpy(), want) <= 1e-4


def test_staged_session_matches_jax_staged_step(interpret):
    """Two steps of the staged path (fused="never") at 256^2: the port's
    planes IFFT against the JAX staged step on its Pallas FFT tier."""
    n = 256
    jp = J.default_cascades()
    jcfg = J.SimConfig(map_size=n, fused="never", fft_impl="pallas", map_dtype="float32")
    js = J.init_state(jcfg, jp)
    tcfg = T.SimConfig(map_size=n, fused="never", map_dtype="float32")
    tp = convert.params_from_numpy(leaves(jp), device="cpu")
    ts = convert.state_from_numpy(leaves(js), device="cpu")
    assert tcfg.step_tier() == "staged" and planes_fft.covers(n)
    for _ in range(2):
        js, jm = jocean.step_impl(jcfg, js, jp, 0.05)
        ts, tm = tocean.step(tcfg, ts, tp, 0.05)
    assert rel_rms(tm.displacement.numpy(), jm.displacement) <= 1e-4
    assert rel_rms(tm.normal.numpy(), jm.normal) <= 1e-4
    assert float(np.sqrt(np.mean((ts.foam.numpy() - np.asarray(js.foam)) ** 2))) <= 1e-4
    np.testing.assert_array_equal(ts.time.numpy(), np.asarray(js.time))


def test_planes_fft_checks_its_input():
    with pytest.raises(ValueError, match="L, 2, N, N"):
        planes_fft.ifft2_packed_planes(torch.zeros(2, 16, 16))
    with pytest.raises(TypeError, match="float32"):
        planes_fft.ifft2_packed_planes(torch.zeros(1, 2, 16, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        planes_fft.ifft2_packed_planes(torch.zeros(1, 2, 16, 16).transpose(-1, -2))
    assert [n for n in (4, 8, 16, 1024, 8192, 16384) if planes_fft.covers(n)] == [16, 1024, 8192]
