"""The rows DFT of the port (`ops/rows_fft.py`, plain version on the CPU) vs
the JAX package: its Pallas rows kernel `idft_rows_planes_pallas` in
interpret mode, and `fft.idft_rows(impl="xla")` at sizes and row counts the
TPU kernel does not take. Tolerance: <= 1e-4 relative RMS, the class of
tests/test_pallas_fft.py:59-73.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from godotoceanwaves_tpu.ops import fft as jfft, pallas_fft
from godotoceanwaves_tpu_torch.ops import fft, rows_fft


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.complex128)
    ref = np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / np.mean(np.abs(ref) ** 2)))


def planes(rs, lead, r, n):
    return (rs.randn(lead, 2, r, n) / n).astype(np.float32)


def as_complex(p):
    p = np.asarray(p)
    return p[:, 0] + 1j * p[:, 1]


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("fold", [False, True])
def test_rows_matches_jax_rows_kernel_interpret(n, fold, monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x = planes(np.random.RandomState(n), 3, 256, n)
    want = np.asarray(pallas_fft.idft_rows_planes_pallas(jnp.asarray(x), fold_sign=fold))
    got = rows_fft.idft_rows_planes(torch.from_numpy(x), fold_sign=fold)
    assert got.shape == (3, 2, 256, n) and got.dtype == torch.float32
    assert rel_rms(as_complex(got.numpy()), as_complex(want)) <= 1e-4


@pytest.mark.parametrize("n", [16, 64, 2048])
@pytest.mark.parametrize("fold", [False, True])
def test_rows_tail_rows_match_jax_xla(n, fold):
    """R = 37 rows (no alignment) and N outside the TPU kernel's 128..1024."""
    x = planes(np.random.RandomState(n + 1), 2, 37, n)
    want = jfft.idft_rows(jnp.asarray(as_complex(x)), impl="xla", fold_sign=fold)
    got = rows_fft.idft_rows_planes(torch.from_numpy(x), fold_sign=fold)
    assert rel_rms(as_complex(got.numpy()), np.asarray(want)) <= 1e-4
    zc = fft.idft_rows(torch.from_numpy(as_complex(x)), fold_sign=fold)
    assert rel_rms(zc.numpy(), np.asarray(want)) <= 1e-4


def test_rows_wrapper_checks_its_input():
    x = torch.zeros(2, 2, 8, 16)
    with pytest.raises(ValueError, match=r"\(L, 2, R, N\)"):
        rows_fft.idft_rows_planes(x[:, :1])
    with pytest.raises(TypeError, match="float32"):
        rows_fft.idft_rows_planes(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rows_fft.idft_rows_planes(x.transpose(-2, -1))
    assert [rows_fft.covers(n) for n in (8, 16, 8192, 16384, 48)] == [False, True, True, False,
                                                                      False]
