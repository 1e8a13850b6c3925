"""2D inverse FFT of the packed spectra (PyTorch port of `ops/fft.py`).

Each 1D pass is the UNNORMALIZED positive-exponent DFT,
X[k] = sum_n x[n] e^{+2pi i nk/N} (fft_butterfly.glsl:27, no 1/N scaling in
fft_compute.glsl). The reference chain per layer is rows -> transpose -> rows
with NO second transpose (wave_generator.gd:77-82), so the field comes out
transposed (a 90 degree rotation the reference deems visually irrelevant).

One plain tier: `torch.fft` with `norm="forward"`, whose inverse transform
carries no scaling. The JAX package's matmul / direct / fourstep / Pallas
tiers exist only because `jnp.fft` is missing on the TPU.
"""
from __future__ import annotations

import torch

from . import grid


def idft_rows(x: torch.Tensor, fold_sign: bool = False) -> torch.Tensor:
    """Unnormalized positive-exponent DFT along the last axis of complex `x`
    (one pass of the reference chain); with fold_sign, output index k is
    also scaled by (-1)^k."""
    out = torch.fft.ifft(x, dim=-1, norm="forward")
    if fold_sign:
        k = torch.arange(x.shape[-1], device=x.device)
        out = out * (1.0 - 2.0 * (k % 2).to(torch.float32))
    return out


def idft_rows_planes(x: torch.Tensor, fold_sign: bool = False) -> torch.Tensor:
    """Plane-pair front end of `idft_rows`: x is (..., 2, R, N) fp32 (Re, Im)
    planes. The plain version of the rows kernel (`ops/rows_fft.py`)."""
    out = idft_rows(torch.complex(x[..., 0, :, :], x[..., 1, :, :]), fold_sign)
    return torch.stack([out.real, out.imag], dim=-3)


def ifft2_packed(x: torch.Tensor, fold_sign: bool = False) -> torch.Tensor:
    """transpose(N^2 * ifft2(x)) over the last two axes of complex `x`; with
    fold_sign also multiplied by (-1)^(x+y) (the ifftshift of
    fft_unpack.glsl:37-38)."""
    out = torch.fft.ifft2(x, dim=(-2, -1), norm="forward").transpose(-2, -1)
    if fold_sign:
        out = out * grid.sign_shift(x.shape[-1], x.device)
    return out


def ifft2_packed_planes(x: torch.Tensor, fold_sign: bool = True) -> torch.Tensor:
    """Plane-pair front end: x is (..., 2, N, N) fp32 (Re, Im) planes."""
    out = ifft2_packed(torch.complex(x[..., 0, :, :], x[..., 1, :, :]), fold_sign)
    return torch.stack([out.real, out.imag], dim=-3)
