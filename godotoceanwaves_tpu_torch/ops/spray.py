"""The spray step as one hand-written launch (`csrc/spray.cu`).

Replaces no TPU kernel: the JAX package's spray step (`models/spray.py`
`spray_step`) is elementwise work over the particles and a bilinear gather
from the maps, left to XLA's fusion. The port's plain route,
`models/spray.py` `spray_step_plain`, runs it as ~440 PyTorch launches a
step. The kernel advances every particle in one launch, one thread a
particle, rounding each operation as the plain route's launches round it, so
the new state and the attributes equal the plain route's on the card bit for
bit. `models/spray.py` `spray_step` takes this route for a CUDA state and the
plain route for any other.

The kernel reads the maps in place in their own dtype (fp32, bf16 or fp16)
by their strides, so a frame's maps sliced out of a multi-frame stack need no
copy. A call allocates its outputs with `torch.empty`, reads `now` from a 0-d
tensor on the device and makes no host sync, so a captured frame program
that advances the spray stays one graph.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused_step import DTYPE_CODES

# The state's fields in the kernel's order (models/spray.py SprayState).
FIELDS = ("start_pos", "start_time", "lifetime", "custom_z", "scale_factor", "base_scale",
          "active", "has_started", "cycle")
_VECTORS = ("start_pos", "base_scale")                       # (P, 3); the rest (P,)
_DTYPES = {"active": torch.bool, "has_started": torch.bool, "cycle": torch.int32}


def _f32(x: float) -> float:
    """A Python number as an fp32 operand of a PyTorch launch sees it."""
    return float(np.float32(x))


def _recip(x: float) -> float:
    """What PyTorch's CUDA division of an fp32 tensor by the Python number `x`
    multiplies by: fl(1 / fl(x)) in fp32."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(x))


def constants(params) -> list[float]:
    """The kernel's `consts` (csrc/spray.cu, the enum's order) from a
    `SprayParams`: the plain route's Python numbers as its launches take
    them."""
    grid = int(params.num_particles ** 0.5)
    return [_recip(grid - 1.0), _f32(params.emitter_extent), _f32(params.lifetime),
            _f32(params.lifetime * params.lifetime_randomness), _f32(params.system_lifetime),
            _recip(params.lifetime), _recip(0.99 - 0.92), _recip(1.0 - 0.9),
            *(_f32(v) for v in params.particle_scale)]


def check_inputs(num_particles: int, fields, disp, normal, scales, now) -> None:
    """Raises on what the kernel does not take: shapes, dtypes, devices."""
    if len(fields) != len(FIELDS):
        raise ValueError(f"the state has {len(FIELDS)} fields {FIELDS}, got {len(fields)}")
    p = num_particles
    for name, t in zip(FIELDS, fields):
        shape = (p, 3) if name in _VECTORS else (p,)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        want = _DTYPES.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if disp.ndim != 4 or disp.shape[1] != 3 or disp.shape[0] < 1 or disp.shape[2] < 1 \
            or disp.shape[2] != disp.shape[3]:
        raise ValueError(f"disp must be (C, 3, N, N), got {tuple(disp.shape)}")
    c, _, n, _ = disp.shape
    if tuple(normal.shape) != (c, 4, n, n):
        raise ValueError(f"normal must be ({c}, 4, {n}, {n}), got {tuple(normal.shape)}")
    if disp.dtype not in DTYPE_CODES:
        raise TypeError(f"the maps must be one of {list(DTYPE_CODES)}, got {disp.dtype}")
    if normal.dtype != disp.dtype:
        raise TypeError(f"normal is {normal.dtype}, disp {disp.dtype}")
    if tuple(scales.shape) != (c, 4):
        raise ValueError(f"scales must be ({c}, 4), got {tuple(scales.shape)}")
    if tuple(now.shape) != ():
        raise ValueError(f"now must be 0-d, got {tuple(now.shape)}")
    for name, t in (("scales", scales), ("now", now)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (*zip(FIELDS, fields), ("normal", normal), ("scales", scales), ("now", now)):
        if t.device != disp.device:
            raise ValueError(f"{name} is on {t.device}, disp on {disp.device}")


def spray_step(params, fields, disp, normal, scales, now):
    """One spray step on the card: (the new state's fields in FIELDS order,
    (position, scale, dissolve, visible)).

    params: a `SprayParams` (num_particles P, the lifetimes, emitter_extent,
    particle_scale, seed); fields: the state's tensors in FIELDS order, on the
    card; disp (C, 3, N, N) and normal (C, 4, N, N) maps of one dtype, any
    strides; scales (C, 4) fp32; now: 0-d fp32. Raises for a tensor that is
    not on a CUDA device.
    """
    check_inputs(params.num_particles, fields, disp, normal, scales, now)
    dev = disp.device
    if dev.type != "cuda":
        raise ValueError(f"the spray kernel runs on a CUDA device, got {dev}")
    p = params.num_particles
    if p >= 2 ** 31:
        raise NotImplementedError(f"the spray kernel takes < 2^31 particles, got {p}")
    from . import _build
    from ..utils import observability
    ins = [t.contiguous() for t in fields]
    outs = [torch.empty_like(t) for t in ins]
    position = torch.empty((p, 3), dtype=torch.float32, device=dev)
    scale = torch.empty((p, 3), dtype=torch.float32, device=dev)
    dissolve = torch.empty((p,), dtype=torch.float32, device=dev)
    visible = torch.empty((p,), dtype=torch.bool, device=dev)
    scales = scales.contiguous()
    strides = (ctypes.c_longlong * 8)(*disp.stride(), *normal.stride())
    k = constants(params)
    consts = (ctypes.c_float * len(k))(*k)
    with torch.cuda.device(dev), observability.span("kernel.spray"):
        _build.launch("spray", "spray_step", *(t.data_ptr() for t in ins), disp.data_ptr(),
                      normal.data_ptr(), strides, DTYPE_CODES[disp.dtype], disp.shape[0],
                      disp.shape[2], scales.data_ptr(), now.data_ptr(), consts, p,
                      int(p ** 0.5), (params.seed + 1) % 2 ** 32,
                      *(t.data_ptr() for t in outs), position.data_ptr(), scale.data_ptr(),
                      dissolve.data_ptr(), visible.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    return outs, (position, scale, dissolve, visible)
