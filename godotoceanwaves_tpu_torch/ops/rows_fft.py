"""The row DFT of (L, 2, R, N) fp32 planes: the shard-local pass of the
row-sharded 2D IFFT (`parallel/sharding.py`).

Replaces `godotoceanwaves_tpu/ops/pallas_fft.py` `idft_rows_planes_pallas`
(the Pallas kernel `_rows_tile_kernel`). Same contract as the plain
`fft.idft_rows_planes`: the unnormalized positive-exponent DFT along the
last axis of each (Re, Im) plane pair, times (-1)^k on output column k with
`fold_sign`. On a CUDA tensor it launches the kernel in `csrc/rows_fft.cu`
(one pass of the register-resident Stockham core `csrc/stockham.cuh`, with
the launch plan and the twiddle table of `fft_plan.py`); on a CPU tensor it
runs `fft.idft_rows_planes`, which stays the plain version.

The kernel is bound by device memory bandwidth: 16 bytes per complex element
(planes in, planes out). It takes any R >= 1 and power-of-two N from 16 to
8192, with no row or lane alignment.
"""
from __future__ import annotations

import torch

from . import fft, fft_plan

MIN_N, MAX_N = 16, 8192

# Kernel launches since the last reset (a launch captured in a CUDA graph
# counts at each replay: utils/graphs.py).
LAUNCHES = 0


def covers(n: int) -> bool:
    """Whether the kernel takes rows of length N (a power of two in [MIN_N, MAX_N])."""
    return n & (n - 1) == 0 and MIN_N <= n <= MAX_N


def _launch(x: torch.Tensor, fold_sign: bool) -> torch.Tensor:
    global LAUNCHES
    l, _, r, n = x.shape
    if not covers(n):
        raise NotImplementedError(
            f"the rows CUDA DFT covers power-of-two N in [{MIN_N}, {MAX_N}], got N={n}")
    from . import _build
    from ..utils import graphs
    lib = _build.load()
    dev = x.device
    with torch.cuda.device(dev):
        plan = fft_plan.rows_plan(n)
        tw = fft_plan.twiddles(n, dev)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rows_fft(x.data_ptr(), out.data_ptr(), tw.data_ptr(), l, r, n, int(fold_sign),
                          plan.seqs, plan.pitch, 0, stream)
        if rc:
            raise RuntimeError(f"rows_fft launch failed: cudaError {rc}")
        LAUNCHES += graphs.counted(__name__)
    return out


def idft_rows_planes(x: torch.Tensor, fold_sign: bool = False) -> torch.Tensor:
    """x: (L, 2, R, N) fp32 (Re, Im) planes, contiguous. A CUDA tensor
    launches the kernel, and raises for N it does not cover; a CPU tensor
    runs the plain `fft.idft_rows_planes`."""
    if x.ndim != 4 or x.shape[1] != 2:
        raise ValueError(f"x must be (L, 2, R, N), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cuda":
        return _launch(x, fold_sign)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fft.idft_rows_planes(x, fold_sign)
