"""The strip step: the fused per-cascade ocean step for 2048 <= N <= 8192.

Replaces `godotoceanwaves_tpu/ops/pallas_strip.py` `strip_cascade_step` (the
Pallas kernels `_pass1_kernel` and `_pass2_kernel`). It takes the arguments
of `fused_step.fused_cascade_step` and returns the same results. On a CUDA
tensor it launches the kernel pair in `csrc/strip_step.cu`: K1's row and
column passes (`csrc/step_passes.cuh`, on the Stockham core) with the
launch plans of `fft_plan.strip_rows_plan` and `strip_cols_plan`: 2 blocks
share each row and column at 2048 and 4096, 4 at 8192, one per output
parity, each transforming `fft_plan.strip_length(N)` points (see the design
note there). On a CPU tensor
it runs the plain PyTorch version, the modulate -> `fft.ifft2_packed_planes`
-> unpack chain.

The pair is bound by device memory bandwidth: about 176 MB per
cascade-frame at 2048^2 (bf16 maps), plus the 268 MB round trip of its
(C, N, N, 8) fp32 scratch of texel records. The new foam is a fresh tensor
(the kernels would allow it to alias the old, as K1's frames do).

What the TPU kernels needed and these do not: the sigma digit un-swap, the
block-tiled (c, 4, 2, s, r, 128, 128) exchange layout, `buffer_count`
window pipelining and the f16 output-window cast (Hopper stores f16).
"""
from __future__ import annotations

import torch

from . import fft_plan, fused_step

MIN_N, MAX_N = 2048, 8192

# Kernel launches (row and column pass each count one) since the last reset
# (a launch captured in a CUDA graph counts at each replay: utils/graphs.py).
LAUNCHES = 0


def strip_cascade_step_reference(h0, h0nc, omega, foam, scalars, *,
                                 map_dtype=torch.bfloat16):
    """Plain PyTorch version of `strip_cascade_step` (modulate -> fft -> unpack)."""
    return fused_step.fused_cascade_step_reference(h0, h0nc, omega, foam, scalars,
                                                   map_dtype=map_dtype)


def _launch(h0, h0nc, omega, foam, scalars, map_dtype):
    global LAUNCHES
    c, _, n, _ = h0.shape
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise NotImplementedError(
            f"the strip CUDA step covers power-of-two N in [{MIN_N}, {MAX_N}], got N={n}")
    from . import _build
    from ..utils import graphs
    lib = _build.load()
    dev = h0.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, cols = fft_plan.strip_rows_plan(n), fft_plan.strip_cols_plan(n)
        tw = fft_plan.twiddles(rows.n, dev)   # the transform's stages
        twn = fft_plan.twiddles(n, dev)       # the split's w_N^(e j)
        scratch = torch.empty((c, n, n, 2 * fft_plan.LAYERS), dtype=torch.float32, device=dev)
        disp = torch.empty((c, 3, n, n), dtype=map_dtype, device=dev)
        normal = torch.empty((c, 4, n, n), dtype=map_dtype, device=dev)
        foam_out = torch.empty_like(foam)
        rc = lib.strip_step_rows(h0.data_ptr(), h0nc.data_ptr(), omega.data_ptr(),
                                 scalars.data_ptr(), tw.data_ptr(), twn.data_ptr(),
                                 scratch.data_ptr(), c, n, rows.lines, rows.pitch,
                                 rows.join_pitch, stream)
        if rc:
            raise RuntimeError(f"strip_step_rows launch failed: cudaError {rc}")
        LAUNCHES += graphs.counted(__name__)
        rc = lib.strip_step_cols(
            scratch.data_ptr(), foam.data_ptr(), scalars.data_ptr(), tw.data_ptr(),
            twn.data_ptr(), disp.data_ptr(), normal.data_ptr(), foam_out.data_ptr(), c, n,
            fused_step.DTYPE_CODES[map_dtype], disp.stride(0), normal.stride(0), cols.lines,
            cols.pitch, cols.join_pitch, stream)
        if rc:
            raise RuntimeError(f"strip_step_cols launch failed: cudaError {rc}")
        LAUNCHES += graphs.counted(__name__)
    return disp, normal, foam_out


def strip_cascade_step(h0, h0nc, omega, foam, scalars, *, map_dtype=torch.bfloat16):
    """One frame for C cascades at 2048 <= N <= 8192.

    h0/h0nc: (C, 2, N, N) fp32 planes; omega: (C, N, N) fp32 host-exact
    dispersion; foam: (C, N, N) fp32; scalars: (C, 1, NUM_SCALARS) fp32
    (`fused_step.pack_scalars`). Returns (displacement (C,3,N,N), normal
    (C,4,N,N) in `map_dtype`, foam (C,N,N) fp32). A CUDA tensor launches the
    kernel pair, and raises for N outside [MIN_N, MAX_N]; a CPU tensor runs
    the plain version at any N.
    """
    fused_step.check_inputs(h0, h0nc, omega, foam, scalars, map_dtype, 1)
    if h0.device.type == "cuda":
        return _launch(h0, h0nc, omega, foam, scalars, map_dtype)
    if h0.device.type != "cpu":
        raise ValueError(f"unsupported device {h0.device}")
    return strip_cascade_step_reference(h0, h0nc, omega, foam, scalars, map_dtype=map_dtype)
