"""Bracket-march a uniform height table along per-pixel rays.

Replaces `godotoceanwaves_tpu/ops/pallas_march.py` `march_heightfield` (the
Pallas kernel `_march_kernel`), the renderer's march_impl="pallas". Per
pixel: `march_steps` samples of (t0, t1] for the first below-surface
crossing (a pixel already below the surface at t0 brackets (t0, t0 + seg)),
then `refine_rounds` rounds of 8-way subdivision. The table is sampled with
the TPU kernel's numbers: bf16 table, bf16 z hat weights, and fp32 x hat
weights (pallas_march.py:69 and :73; the renderer's `_mxu_sample` rounds
both), fp32 sums. Geometry is folded into per-pixel linear forms:

    table coord fx(t) = ax + t * bx,  ax = (cam_x - center_x - origin) / cell,
                                      bx = dir_x / cell       (same for z)
    below(t)          = cam_y + t * dir_y < h(fx(t), fz(t))

On a CUDA tensor `march_heightfield` is one launch of `csrc/march.cu`: the
kernel takes the rays, window, mask, camera and centre as they come and
the table by its strides (fp32 or bf16; the renderer's is a strided
slice), forms the linear forms with `_lanes`'s fp32 operations, and writes
`found` straight into a bool tensor. Its cooperative grid first copies the
table into a compact bf16 scratch that stays in L1, then marches a thread
a pixel in groups of 4 samples, every load of a group issued before its
first compare, and stops a round between groups at its first crossing
(the samples after it cannot change the result). On a CPU tensor it runs
the plain version, a vectorised transliteration of `_march_kernel`. The
kernel is bound by its table reads: each sample reads 4 texels; per pixel
5 floats and a byte come in, a byte and 2 floats go out.
"""
from __future__ import annotations

import numpy as np
import torch

# Kernel launches since the last reset (a launch captured in a CUDA graph
# counts at each replay: utils/graphs.py).
LAUNCHES = 0


def _f32(x: float) -> float:
    return float(np.float32(x))


def _below(flat, g: int, hi_cap: float, ax, az, cy, bx, bz, dy, t):
    fx = torch.clamp(ax + t * bx, 0.0, hi_cap)
    fz = torch.clamp(az + t * bz, 0.0, hi_cap)
    i = fz.long()                       # fz >= 0: truncation is floor
    j = fx.long()
    wz0 = torch.clamp_min(1.0 - torch.abs(fz - i.float()), 0.0).to(torch.bfloat16).float()
    wz1 = torch.clamp_min(1.0 - torch.abs(fz - (i + 1).float()), 0.0).to(torch.bfloat16).float()
    wx0 = torch.clamp_min(1.0 - torch.abs(fx - j.float()), 0.0)
    wx1 = torch.clamp_min(1.0 - torch.abs(fx - (j + 1).float()), 0.0)
    at = lambda zi, xi: flat[zi * g + xi].float()
    r0 = wz0 * at(i, j) + wz1 * at(i + 1, j)
    r1 = wz0 * at(i, j + 1) + wz1 * at(i + 1, j + 1)
    return (cy + t * dy) < r0 * wx0 + r1 * wx1


def march_reference(table16, bx, bz, dy, t0, t1, valid, ax, az, cy, *,
                    march_steps: int, refine_rounds: int):
    """Plain version on flat (P,) lanes: (found, lo, hi)."""
    g = table16.shape[0]
    flat = table16.reshape(-1)
    hi_cap = float(np.float32(g) - np.float32(1.001))
    below = lambda t: _below(flat, g, hi_cap, ax, az, cy, bx, bz, dy, t)

    def run_round(lo, hi, m, ok):
        seg = (hi - lo) * _f32(1.0 / m)
        hit = torch.zeros_like(ok)
        t_first = lo
        for idx in range(m):
            t = lo + (idx + 1.0) * seg
            b = below(t) & ok
            t_first = torch.where(b & ~hit, t, t_first)
            hit = hit | b
        return hit, torch.where(hit, t_first - seg, lo), torch.where(hit, t_first, hi)

    b0 = below(t0) & valid
    hit, lo, hi = run_round(t0, t1, march_steps, valid & ~b0)
    seg0 = (t1 - t0) * _f32(1.0 / march_steps)
    lo = torch.where(b0, t0, lo)
    hi = torch.where(b0, t0 + seg0, hi)
    found = hit | b0
    for _ in range(refine_rounds):
        _, lo, hi = run_round(lo, hi, 8, found)
    return found, lo, hi


def _launch(table, dirs, t0, t1, valid, cam, center_xz, origin, cell, *, march_steps,
            refine_rounds):
    global LAUNCHES
    p, g = t0.numel(), table.shape[0]
    if p >= 2 ** 31 or g * g >= 2 ** 31:
        raise NotImplementedError(f"the march kernel takes < 2^31 pixels and texels, got {p} "
                                  f"and {g * g}")
    from . import _build
    from ..utils import graphs
    lib = _build.load()
    dev = table.device
    # the table by its strides; the rest are views where contiguous, as the
    # renderer's are
    d, a, b = dirs.contiguous(), t0.contiguous(), t1.contiguous()
    ok, c, ctr = valid.contiguous(), cam.contiguous(), center_xz.contiguous()
    compact = torch.empty(g * g, dtype=torch.bfloat16, device=dev)     # the kernel's scratch
    found = torch.empty(t0.shape, dtype=torch.bool, device=dev)
    lo = torch.empty(t0.shape, dtype=torch.float32, device=dev)
    hi = torch.empty(t0.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.march_heightfield(
            table.data_ptr(), int(table.dtype == torch.bfloat16), *table.stride(),
            compact.data_ptr(), d.data_ptr(), a.data_ptr(), b.data_ptr(), ok.data_ptr(),
            c.data_ptr(), ctr.data_ptr(), _f32(origin), _f32(1.0 / float(cell)),
            found.data_ptr(), lo.data_ptr(), hi.data_ptr(), p, g, march_steps,
            _f32(1.0 / march_steps), refine_rounds,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"march_heightfield launch failed: cudaError {rc}")
    LAUNCHES += graphs.counted(__name__)
    return found, lo, hi


def _check(table, dirs, t0, t1, valid, cam, center_xz, march_steps, refine_rounds):
    shape = tuple(t0.shape)
    if table.ndim != 2 or table.shape[0] != table.shape[1] or table.shape[0] < 2:
        raise ValueError(f"table must be (G, G) with G >= 2, got {tuple(table.shape)}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if tuple(dirs.shape) != shape + (3,):
        raise ValueError(f"dirs must be {shape + (3,)}, got {tuple(dirs.shape)}")
    for name, t in (("t1", t1), ("valid", valid)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("dirs", dirs), ("t0", t0), ("t1", t1), ("cam", cam),
                    ("center_xz", center_xz)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if tuple(cam.shape) != (3,) or tuple(center_xz.shape) != (2,):
        raise ValueError(f"cam must be (3,) and center_xz (2,), got {tuple(cam.shape)} and "
                         f"{tuple(center_xz.shape)}")
    for name, t in (("dirs", dirs), ("t0", t0), ("t1", t1), ("valid", valid), ("cam", cam),
                    ("center_xz", center_xz)):
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
    if march_steps < 1 or refine_rounds < 0:
        raise ValueError(f"march_steps must be >= 1 and refine_rounds >= 0, got "
                         f"{march_steps} and {refine_rounds}")


def _lanes(table, dirs, t0, t1, valid, cam, center_xz, origin, cell):
    """The bf16 table, the per-pixel lanes (bx, bz, dy, t0, t1, valid) flat,
    and the 0-d scalars (ax, az, cy), as pallas_march.py:138-148 folds them."""
    inv_cell = _f32(1.0 / float(cell))
    org = _f32(origin)
    flat = lambda a: a.reshape(-1).contiguous()
    lanes = (flat(dirs[..., 0] * inv_cell), flat(dirs[..., 2] * inv_cell), flat(dirs[..., 1]),
             flat(t0), flat(t1), flat(valid))
    scal = ((cam[0] - center_xz[0] - org) * inv_cell, (cam[2] - center_xz[1] - org) * inv_cell,
            cam[1])
    return table.to(torch.bfloat16).contiguous(), lanes, scal


def march_heightfield_reference(table, dirs, t0, t1, valid, cam, center_xz, origin, cell, *,
                                march_steps: int = 24, refine_rounds: int = 2):
    """Plain version of `march_heightfield`, on any device."""
    _check(table, dirs, t0, t1, valid, cam, center_xz, march_steps, refine_rounds)
    table16, lanes, scal = _lanes(table, dirs, t0, t1, valid, cam, center_xz, origin, cell)
    out = march_reference(table16, *lanes, *scal, march_steps=march_steps,
                          refine_rounds=refine_rounds)
    return tuple(a.reshape(t0.shape) for a in out)


def march_heightfield(table: torch.Tensor, dirs: torch.Tensor, t0: torch.Tensor,
                      t1: torch.Tensor, valid: torch.Tensor, cam: torch.Tensor,
                      center_xz: torch.Tensor, origin, cell, *,
                      march_steps: int = 24, refine_rounds: int = 2):
    """Bracket-march the (G, G) height table along per-pixel rays.

    table: (G, G) float32 or bf16 height (z-major, the
    `uniform_from_graded(...)[..., 1]` march grid); dirs: (..., 3) float32
    unit rays from `cam` (3,); t0/t1: (...) float32 march window; valid:
    (...) bool marchable mask; center_xz (2,); origin/cell: the grid's
    `_uniform_resample_tables` constants (Python floats). Returns (found
    bool, lo, hi) of shape (...): the tightened bracket around the first
    crossing. A CUDA tensor launches the kernel; a CPU tensor runs the
    plain version.
    """
    dev = table.device
    if dev.type == "cpu":
        return march_heightfield_reference(table, dirs, t0, t1, valid, cam, center_xz, origin,
                                           cell, march_steps=march_steps,
                                           refine_rounds=refine_rounds)
    _check(table, dirs, t0, t1, valid, cam, center_xz, march_steps, refine_rounds)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(table, dirs, t0, t1, valid, cam, center_xz, origin, cell,
                   march_steps=march_steps, refine_rounds=refine_rounds)
