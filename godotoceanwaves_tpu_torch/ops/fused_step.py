"""The fused per-cascade ocean step: modulate -> 2D IFFT -> unpack + foam.

Replaces `godotoceanwaves_tpu/ops/pallas_step.py` `_fused_call` (the Pallas
kernel `_step_kernel` -> `_one_frame`, reached through `fused_cascade_step`
and `fused_cascade_multi_step`). On a CUDA tensor the wrappers launch the
hand-written kernel pair in `csrc/fused_step.cu` (a row pass and a column
pass on the Stockham core `csrc/stockham.cuh`, with the launch plans and
twiddle table of `fft_plan`; see the design note there); on a CPU tensor
they run the plain PyTorch version built from `modulate`, `fft` and
`unpack`.

The pair is bound by device memory bandwidth: about 44 MB per cascade-frame
at 1024^2 (spectra, omega and foam in; foam and bf16 maps out), plus a
32 MB fp32 scratch written and read back, (C, N, N, 8): the 4 transformed
layers of a texel as one 32-byte record. It pays that round trip in
exchange for never holding a whole layer on chip.

What the TPU kernel needed and this one does not: the VMEM-resident
four-step DFT, the sigma digit un-swap, the map-dtype keeper planes (normals
here come from fp32 gradients, rounded once, as the staged path does) and
the f16 output-window cast (Hopper stores f16 natively).
"""
from __future__ import annotations

import torch

from . import fft, fft_plan, modulate, unpack

# Per-cascade scalar row layout (pallas_step.py:43). S_TIME is frame 0's
# modulation time; frame k modulates at S_TIME + k * S_DT.
S_TIME, S_LX, S_LY, S_WHITECAP, S_GROW, S_DECAY, S_DT = range(7)
NUM_SCALARS = 8

MIN_N, MAX_N = 16, 1024

# Kernel launches (row and column pass each count one) since the last reset
# (a launch captured in a CUDA graph counts at each replay: utils/graphs.py).
LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def pack_scalars(time, tile_length, whitecap, grow, decay, dt=None) -> torch.Tensor:
    """(C, 1, NUM_SCALARS) fp32 scalar rows [t, Lx, Ly, whitecap, grow, decay, dt, 0].

    `time` is frame 0's modulation time; `dt` (multi-frame only) is the
    per-frame increment.
    """
    zeros = torch.zeros_like(time)
    dt_col = zeros if dt is None else zeros + dt
    return torch.stack([
        time, tile_length[..., 0], tile_length[..., 1],
        whitecap, grow, decay, dt_col, zeros,
    ], dim=-1).to(torch.float32)[:, None, :]


def check_inputs(h0, h0nc, omega, foam, scalars, map_dtype, num_frames):
    c, two, n, n2 = h0.shape
    if two != 2 or n != n2:
        raise ValueError(f"h0 must be (C, 2, N, N), got {tuple(h0.shape)}")
    expected = {"h0": (h0, (c, 2, n, n)), "h0nc": (h0nc, (c, 2, n, n)),
                "omega": (omega, (c, n, n)), "foam": (foam, (c, n, n)),
                "scalars": (scalars, (c, 1, NUM_SCALARS))}
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != h0.device:
            raise ValueError(f"{name} is on {t.device}, h0 on {h0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if map_dtype not in DTYPE_CODES:
        raise TypeError(f"map_dtype must be one of {list(DTYPE_CODES)}, got {map_dtype}")
    if num_frames < 1:
        raise ValueError(f"num_frames must be >= 1, got {num_frames}")


def _reference_frame(h0, h0nc, omega, foam, scalars, frame: int, map_dtype):
    s = scalars[:, 0]
    # frame k modulates at S_TIME + k * S_DT, two fp32 roundings like the kernel
    t = s[:, S_TIME] + s[:, S_DT] * float(frame)
    layers = modulate.modulate_planes(h0, h0nc, s[:, S_LX:S_LY + 1], None, t, omega=omega)
    # the plain torch.fft version, never the planes kernel: this is what the
    # kernels (K1 here, K4 in strip_step) are held against
    fields = fft.ifft2_packed_planes(layers, fold_sign=True)
    col = lambda i: s[:, i, None, None]
    return unpack.unpack_planes(fields, foam, col(S_WHITECAP), col(S_GROW), col(S_DECAY),
                                pre_shifted=True, map_dtype=map_dtype)


def fused_cascade_step_reference(h0, h0nc, omega, foam, scalars, *,
                                 map_dtype=torch.bfloat16):
    """Plain PyTorch version of `fused_cascade_step` (modulate -> fft -> unpack)."""
    return _reference_frame(h0, h0nc, omega, foam, scalars, 0, map_dtype)


def fused_cascade_multi_step_reference(h0, h0nc, omega, foam, scalars, *,
                                       num_frames: int, map_dtype=torch.bfloat16):
    """Plain PyTorch version of `fused_cascade_multi_step`."""
    disps, normals = [], []
    for k in range(num_frames):
        d, nm, foam = _reference_frame(h0, h0nc, omega, foam, scalars, k, map_dtype)
        disps.append(d)
        normals.append(nm)
    return torch.stack(disps, dim=1), torch.stack(normals, dim=1), foam


def _launch(h0, h0nc, omega, foam, scalars, *, num_frames: int, map_dtype, multi: bool):
    global LAUNCHES
    c, _, n, _ = h0.shape
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise NotImplementedError(
            f"the fused CUDA step covers power-of-two N in [{MIN_N}, {MAX_N}], got "
            f"N={n}; N in (1024, 8192] is the strip kernel's (ops/strip_step.py, the "
            f"port of godotoceanwaves_tpu/ops/pallas_strip.py), other sizes take the "
            f"staged path (SimConfig.step_tier)")
    from . import _build
    from ..utils import graphs
    lib = _build.load()
    dev = h0.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, cols = fft_plan.step_rows_plan(n), fft_plan.step_cols_plan(n)
        tw = fft_plan.twiddles(n, dev)
        scratch = torch.empty((c, n, n, 2 * fft_plan.LAYERS), dtype=torch.float32, device=dev)
        lead = (c, num_frames) if multi else (c,)
        disp = torch.empty(lead + (3, n, n), dtype=map_dtype, device=dev)
        normal = torch.empty(lead + (4, n, n), dtype=map_dtype, device=dev)
        foam_out = torch.empty_like(foam)
        for k in range(num_frames):
            rc = lib.fused_step_rows(h0.data_ptr(), h0nc.data_ptr(), omega.data_ptr(),
                                     scalars.data_ptr(), tw.data_ptr(), scratch.data_ptr(), c, n,
                                     k, rows.lines, rows.pitch, rows.join_pitch, stream)
            if rc:
                raise RuntimeError(f"fused_step_rows launch failed: cudaError {rc}")
            LAUNCHES += graphs.counted(__name__)
            foam_in = foam if k == 0 else foam_out   # in place from frame 1 on
            d_k, n_k = (disp[:, k], normal[:, k]) if multi else (disp, normal)
            rc = lib.fused_step_cols(
                scratch.data_ptr(), foam_in.data_ptr(), scalars.data_ptr(), tw.data_ptr(),
                d_k.data_ptr(), n_k.data_ptr(), foam_out.data_ptr(), c, n,
                DTYPE_CODES[map_dtype], d_k.stride(0), n_k.stride(0), cols.lines, cols.pitch,
                cols.join_pitch, stream)
            if rc:
                raise RuntimeError(f"fused_step_cols launch failed: cudaError {rc}")
            LAUNCHES += graphs.counted(__name__)
    return disp, normal, foam_out


def _dispatch(h0, h0nc, omega, foam, scalars, *, num_frames, map_dtype, multi):
    check_inputs(h0, h0nc, omega, foam, scalars, map_dtype, num_frames)
    if h0.device.type == "cuda":
        return _launch(h0, h0nc, omega, foam, scalars, num_frames=num_frames,
                       map_dtype=map_dtype, multi=multi)
    if h0.device.type != "cpu":
        raise ValueError(f"unsupported device {h0.device}")
    if multi:
        return fused_cascade_multi_step_reference(
            h0, h0nc, omega, foam, scalars, num_frames=num_frames, map_dtype=map_dtype)
    return fused_cascade_step_reference(h0, h0nc, omega, foam, scalars, map_dtype=map_dtype)


def fused_cascade_step(h0, h0nc, omega, foam, scalars, *, map_dtype=torch.bfloat16):
    """Run the fused step for C cascades.

    h0/h0nc: (C, 2, N, N) fp32 planes; omega: (C, N, N) fp32 host-exact
    dispersion; foam: (C, N, N) fp32; scalars: (C, 1, NUM_SCALARS) fp32
    (pack_scalars). Returns (displacement (C,3,N,N), normal (C,4,N,N) in
    `map_dtype`, foam (C,N,N) fp32). A CUDA tensor launches the kernel pair;
    a CPU tensor runs the plain version.
    """
    return _dispatch(h0, h0nc, omega, foam, scalars, num_frames=1,
                     map_dtype=map_dtype, multi=False)


def fused_cascade_multi_step(h0, h0nc, omega, foam, scalars, *, num_frames: int,
                             map_dtype=torch.bfloat16):
    """K consecutive frames; frame k modulates at scalars[S_TIME] + k*scalars[S_DT].

    Returns (displacement (C,K,3,N,N), normal (C,K,4,N,N), final foam (C,N,N)).
    On the card each frame is one row-pass and one column-pass launch; foam
    carries across frames in place.
    """
    return _dispatch(h0, h0nc, omega, foam, scalars, num_frames=num_frames,
                     map_dtype=map_dtype, multi=True)
