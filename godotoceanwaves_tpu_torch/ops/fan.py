"""The fan march's bracket select as one hand-written launch (`csrc/fan.cu`).

Replaces no TPU kernel: the JAX package's fan march (`models/geometry.py`
`_fan_select`) writes each pixel's first-crossing search as broadcast
operations over (H/g, g, W, J) and leaves them to XLA's fusion. The plain
route here, `fan_tsel_plain` and `fan_epilogue_plain`, is that chain in
PyTorch, one launch an operation: at 1280x720, g = 8 and J = 320 each of its
tensors holds 294,912,000 elements. The kernel finds each pixel's first
crossing directly, forming the depth profile on the fly from the fan table,
and writes `found`, `t_lo` and `t_hi` (and `tsel` on request) bit-equal to
the chain: `tau` strictly increasing makes the chain's `amin` the first
qualifying index, and every product and sum is rounded as the chain rounds
it. The renderer's prologue (`dxz`, `s`, the `atan2`, the fan table, the
row-group mean and the hat index and weights) stays PyTorch and feeds both
routes; `fan_bracket` takes the kernel on a CUDA tensor and the chain on a
CPU tensor. A kernel call allocates its outputs with `torch.empty`, reads
`cam_y` on the device and makes no host sync, so a render that runs it stays
one captured graph.
"""
from __future__ import annotations

import math

import torch


def fan_tsel_plain(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam) -> torch.Tensor:
    """Each pixel's first-crossing tau (H, W), +inf where none: the smallest
    tau_j with fl(fl(s tau_j) + cam_y) below the group's profile
    fl(fl(w0 hfan[i0, j]) + fl(w1 hfan[i0 + 1, j])) and inside the window
    (t0 dxz, t1 dxz] of a marchable pixel, as broadcast operations over
    (H/g, g, W, J). The plain version of the kernel; any device."""
    hgt, wid = s.shape
    g = hgt // i0.shape[0]
    prof = w0[..., None] * hfan[i0] + w1[..., None] * hfan[i0 + 1]   # (H/g, W, J)
    shape = (hgt // g, g, wid, 1)
    tau0 = (t0 * dxz).reshape(shape)
    tau1 = (t1 * dxz).reshape(shape)
    sy = s.reshape(shape)
    z = sy * tau                                             # (H/g, g, W, J)
    z.add_(cam[1])
    cand = z < prof[:, None]
    del z
    cand &= tau > tau0
    cand &= tau <= tau1
    cand &= marchable.reshape(shape)
    tsel = torch.where(cand, tau, math.inf).amin(dim=-1).reshape(hgt, wid)
    del cand
    return tsel


def fan_epilogue_plain(tsel, marchable, dxz, t0, t1, ratio: float):
    """(found, t_lo, t_hi) from `fan_tsel_plain`'s tsel: the bracket
    (max(t0, t_hi ratio), t_hi] in ray-parameter units where found, the
    window (t0, t1] where not."""
    found = torch.isfinite(tsel) & marchable
    tsel = torch.where(found, tsel, 1.0)     # keep inf out of the algebra
    t_hi = torch.where(found, tsel / dxz, t1)
    t_lo = torch.where(found, torch.maximum(t0, t_hi * ratio), t0)
    return found, t_lo, t_hi


def fan_bracket_plain(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio: float,
                      *, with_tsel: bool = False):
    """The plain route of `fan_bracket`, on any device: (found, t_lo, t_hi),
    and tsel last with `with_tsel`."""
    tsel = fan_tsel_plain(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam)
    out = fan_epilogue_plain(tsel, marchable, dxz, t0, t1, ratio)
    return (*out, tsel) if with_tsel else out


def check_inputs(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam) -> None:
    """Raises on what neither route takes: shapes, dtypes, devices."""
    if hfan.ndim != 2 or hfan.shape[0] < 2 or hfan.shape[1] < 1:
        raise ValueError(f"hfan must be (phi, J) with phi >= 2, got {tuple(hfan.shape)}")
    phi, taus = hfan.shape
    if tuple(tau.shape) != (taus,):
        raise ValueError(f"tau must be ({taus},), got {tuple(tau.shape)}")
    if s.ndim != 2:
        raise ValueError(f"s must be (H, W), got {tuple(s.shape)}")
    hgt, wid = s.shape
    for name, t in (("t0", t0), ("t1", t1), ("dxz", dxz), ("marchable", marchable)):
        if tuple(t.shape) != (hgt, wid):
            raise ValueError(f"{name} must be ({hgt}, {wid}), got {tuple(t.shape)}")
    if i0.ndim != 2 or i0.shape[1] != wid or i0.shape[0] < 1 or hgt % i0.shape[0]:
        raise ValueError(f"i0 must be (H/g, {wid}) with H/g dividing {hgt}, got "
                         f"{tuple(i0.shape)}")
    for name, t in (("w0", w0), ("w1", w1)):
        if tuple(t.shape) != tuple(i0.shape):
            raise ValueError(f"{name} must be {tuple(i0.shape)}, got {tuple(t.shape)}")
    if tuple(cam.shape) != (3,):
        raise ValueError(f"cam must be (3,), got {tuple(cam.shape)}")
    named = dict(hfan=hfan, tau=tau, w0=w0, w1=w1, s=s, t0=t0, t1=t1, dxz=dxz, cam=cam)
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if i0.dtype != torch.int64:
        raise TypeError(f"i0 must be int64, got {i0.dtype}")
    if marchable.dtype != torch.bool:
        raise TypeError(f"marchable must be bool, got {marchable.dtype}")
    named.update(i0=i0, marchable=marchable)
    for name, t in named.items():
        if t.device != hfan.device:
            raise ValueError(f"{name} is on {t.device}, hfan on {hfan.device}")


def _launch(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio, with_tsel):
    hgt, wid = s.shape
    if hgt * wid >= 2 ** 31 or -(-hgt // 8) > 65535:
        raise NotImplementedError(f"the fan kernel takes < 2^31 pixels and <= 524,280 rows, "
                                  f"got {hgt} x {wid}")
    from . import _build
    from ..utils import observability
    dev = hfan.device
    ins = [t.contiguous() for t in (hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable)]
    cam_y = cam[1]                      # a 0-d view: its pointer is cam's second element
    tsel = torch.empty((hgt, wid), dtype=torch.float32, device=dev) if with_tsel else None
    found = torch.empty((hgt, wid), dtype=torch.bool, device=dev)
    t_lo = torch.empty((hgt, wid), dtype=torch.float32, device=dev)
    t_hi = torch.empty((hgt, wid), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev), observability.span("kernel.fan"):
        _build.launch("fan", "fan_bracket", *(t.data_ptr() for t in ins), cam_y.data_ptr(),
                      ratio, hfan.shape[0], hfan.shape[1], hgt // i0.shape[0], hgt, wid,
                      None if tsel is None else tsel.data_ptr(), found.data_ptr(),
                      t_lo.data_ptr(), t_hi.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    out = (found, t_lo, t_hi)
    return (*out, tsel) if with_tsel else out


def fan_bracket(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio: float,
                *, with_tsel: bool = False):
    """The fan march's bracket select: (found bool, t_lo, t_hi), each (H, W),
    and the first-crossing tau (H, W) last with `with_tsel`.

    hfan: (phi, J) fp32 fan table (heading x log-distance); tau: (J,) fp32,
    strictly increasing; i0 (H/g, W) int64, w0 and w1 (H/g, W) fp32: each row
    group's hat index and weights across phi; s, t0, t1, dxz: (H, W) fp32
    slope, window and horizontal length of each ray; marchable (H, W) bool;
    cam (3,) fp32, read on the device; ratio: tau's step down, a Python
    float. A CUDA tensor launches the kernel, bit-equal to
    `fan_bracket_plain`; a CPU tensor runs `fan_bracket_plain`.
    """
    check_inputs(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam)
    if hfan.device.type == "cuda":
        return _launch(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio, with_tsel)
    if hfan.device.type != "cpu":
        raise ValueError(f"unsupported device {hfan.device}")
    return fan_bracket_plain(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio,
                             with_tsel=with_tsel)
