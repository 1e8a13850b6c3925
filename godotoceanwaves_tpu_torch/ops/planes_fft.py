"""The 2D IFFT of (L, 2, N, N) fp32 planes: the FFT of the staged step.

Replaces `godotoceanwaves_tpu/ops/pallas_fft.py` `ifft2_packed_planes_pallas`
(the Pallas kernel `_ifft2_kernel`). Same contract as the plain
`fft.ifft2_packed_planes` on a plane stack: plane l of the output is
transpose(N^2 ifft2(x_l)) (rows -> transpose -> rows with no second
transpose, unnormalized, positive exponent), times (-1)^(x+y) with
`fold_sign`. On a CUDA tensor it launches two kernels on the Stockham core
`csrc/stockham.cuh`: the rows DFT of `csrc/rows_fft.cu` (K3's kernel),
storing an fp32 intermediate of 32-byte column records, then the column pass
of `csrc/planes_fft.cu`, which writes the output rows (see the design note
there). On a CPU tensor it runs `fft.ifft2_packed_planes`, which stays the
plain version.

The function is bound by device memory bandwidth, 16 bytes per element
(planes in, planes out); the pair moves 32, the intermediate out and back.
"""
from __future__ import annotations

import torch

from . import fft, fft_plan

MIN_N, MAX_N = 16, 8192


def covers(n: int) -> bool:
    """Whether the kernel takes N (a power of two in [MIN_N, MAX_N])."""
    return n & (n - 1) == 0 and MIN_N <= n <= MAX_N


def _launch(x: torch.Tensor, fold_sign: bool) -> torch.Tensor:
    l, _, n, _ = x.shape
    if not covers(n):
        raise NotImplementedError(
            f"the planes CUDA IFFT covers power-of-two N in [{MIN_N}, {MAX_N}], got N={n}")
    from . import _build
    from ..utils import observability
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, cols = fft_plan.rows_plan(n), fft_plan.cols_plan(n)
        tw = fft_plan.twiddles(n, dev)
        mid = torch.empty_like(x)      # (L, 2, N / TILE, N, TILE) records
        out = torch.empty_like(x)
        with observability.span("kernel.planes_fft"):
            _build.launch("planes_fft", "rows_fft", x.data_ptr(), mid.data_ptr(),
                          tw.data_ptr(), l, n, n, 0, rows.seqs, rows.pitch, fft_plan.TILE,
                          stream)
            _build.launch("planes_fft", "planes_fft_cols", mid.data_ptr(), out.data_ptr(),
                          tw.data_ptr(), l, n, int(fold_sign), cols.seqs, cols.pitch,
                          fft_plan.TILE, stream)
    return out


def ifft2_packed_planes(x: torch.Tensor, fold_sign: bool = True) -> torch.Tensor:
    """x: (L, 2, N, N) fp32 (Re, Im) planes, contiguous. A CUDA tensor
    launches the kernel pair, and raises for N it does not cover; a CPU
    tensor runs the plain `fft.ifft2_packed_planes`."""
    if x.ndim != 4 or x.shape[1] != 2 or x.shape[2] != x.shape[3]:
        raise ValueError(f"x must be (L, 2, N, N), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cuda":
        return _launch(x, fold_sign)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fft.ifft2_packed_planes(x, fold_sign)
