"""The strip step: the fused per-cascade ocean step for 1024 < N <= 8192.

Replaces `godotoceanwaves_tpu/ops/pallas_strip.py` `strip_cascade_step` (the
Pallas kernels `_pass1_kernel` and `_pass2_kernel`). It takes the arguments
of `fused_step.fused_cascade_step` and returns the same results. On a CUDA
tensor it launches the kernel pair in `csrc/strip_step.cu` (a row pass and
a column pass over an fp32 scratch, with an in-place shared-memory FFT; see
the design note there); on a CPU tensor it runs the plain PyTorch version,
the modulate -> `fft.ifft2_packed_planes` -> unpack chain.

The pair is bound by device memory bandwidth: about 445 MB per
cascade-frame at 2048^2, of which 268 MB is the scratch round trip.

What the TPU kernels needed and these do not: the sigma digit un-swap, the
block-tiled (c, 4, 2, s, r, 128, 128) exchange layout, `buffer_count`
window pipelining and the f16 output-window cast (Hopper stores f16).
"""
from __future__ import annotations

import torch

from . import fused_step

MIN_N, MAX_N = 2048, 8192

# Kernel launches (row and column pass each count one) since the last reset.
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
    lib = _build.load()
    dev = h0.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = torch.empty((c, n, n, 8), dtype=torch.float32, device=dev)
        disp = torch.empty((c, 3, n, n), dtype=map_dtype, device=dev)
        normal = torch.empty((c, 4, n, n), dtype=map_dtype, device=dev)
        foam_out = torch.empty_like(foam)
        rc = lib.strip_step_rows(h0.data_ptr(), h0nc.data_ptr(), omega.data_ptr(),
                                 scalars.data_ptr(), scratch.data_ptr(), c, n, stream)
        if rc:
            raise RuntimeError(f"strip_step_rows launch failed: cudaError {rc}")
        LAUNCHES += 1
        rc = lib.strip_step_cols(
            scratch.data_ptr(), foam.data_ptr(), scalars.data_ptr(), disp.data_ptr(),
            normal.data_ptr(), foam_out.data_ptr(), c, n, fused_step.DTYPE_CODES[map_dtype],
            disp.stride(0), normal.stride(0), stream)
        if rc:
            raise RuntimeError(f"strip_step_cols launch failed: cudaError {rc}")
        LAUNCHES += 1
    return disp, normal, foam_out


def strip_cascade_step(h0, h0nc, omega, foam, scalars, *, map_dtype=torch.bfloat16):
    """One frame for C cascades at 1024 < N <= 8192.

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
