"""Displaced-geometry renderer: the reference's vertex stage made visible.

Counterpart of `godotoceanwaves_tpu/models/geometry.py`. The reference
renders a clipmap mesh whose vertices ride the displacement maps
(water.gdshader:29-38; mesh at water.gd:8-9,46, camera-snapped at
main.gd:32-37). This module renders that displaced geometry:

  1. `displaced_grid` runs the vertex stage on the clipmap's graded grid.
  2. `render_ocean_geometry` marches each pixel ray against the displaced
     surface (on a uniform resample of the grid, `accel="uniform"`, or the
     graded mesh itself, `accel="exact"`), lands on the first crossing and
     inverts the horizontal chop for the fragment UV (water.gdshader:28).
  3. Hits shade with the C12 fragment/light model (`shading.shade`),
     misses with the procedural sky; past the mesh the flat y=0 plane.

On a CUDA device the default path runs the gradient-tap kernel
(`ops/tap.py`) and, with march_impl="pallas", the heightfield-march kernel
(`ops/march.py`); everything else is plain PyTorch. A frame makes no host
sync and no host-to-device copy: static tables are cached per device, and
camera pose and scalars stay Python numbers or device tensors.
"""
from __future__ import annotations

import functools
import inspect
import math
import warnings

import numpy as np
import torch

from . import shading
from .cascade import require_device
from ..ops import fan
from ..utils import graphs
from ..utils.clipmap import _axis_coords

# the reference ships two clipmap gradings of a 512x512 m plane
# (water.gd:8-9). Same footprint, doubled center/ring density for "high".
CLIPMAP_PRESETS: dict[str, dict] = {
    "low": dict(levels=4, center_res=64, ring_cells=16, extent=512.0),
    "high": dict(levels=4, center_res=128, ring_cells=32, extent=512.0),
}


def _scalar(v, device) -> torch.Tensor:
    """0-d fp32 tensor on `device`: a tensor moves (no copy if it is there),
    a Python number fills on the device (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _vec(v, device) -> torch.Tensor:
    """(n,) fp32 tensor on `device` from a tensor or a sequence of numbers."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.stack([_scalar(x, device) for x in v])


def _on_device(device: torch.device, fn, *args):
    """fn(*args), a static NumPy table (or tuple of them), copied to `device`
    once: integer arrays as long index tensors, float arrays as fp32; other
    members (Python floats) pass through (a CUDA graph that reads it holds
    it: `graphs.keep`). Shared: never write to it."""
    return graphs.keep(_on_device_table(device, fn, *args))


@functools.lru_cache(maxsize=128)
def _on_device_table(device: torch.device, fn, *args):
    def conv(x):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.array(x))
            t = t.long() if not t.is_floating_point() else t.float()
            return t.to(device)
        return x
    out = fn(*args)
    return tuple(conv(x) for x in out) if isinstance(out, tuple) else conv(out)


def _resolve_tap_impl(tap_impl: str, device: torch.device) -> str:
    """The gradient-tap route for a render: "pallas" (the CUDA kernel of
    `ops/tap.py`, any table size) or "einsum" (its plain version).

    "auto" takes the kernel on a CUDA device and the plain version on the
    CPU. The JAX package's values carry over: "pallas" asks for the kernel
    and raises on the CPU; "pallas-interpret" and "einsum" take the plain
    version.
    """
    if tap_impl == "auto":
        return "pallas" if device.type == "cuda" else "einsum"
    if tap_impl == "pallas":
        if device.type != "cuda":
            raise ValueError("tap_impl='pallas' runs the CUDA gradient-tap kernel and needs "
                             f"maps on a CUDA device, got {device}; use 'auto' or 'einsum'")
        return "pallas"
    if tap_impl in ("pallas-interpret", "einsum"):
        return "einsum"
    raise ValueError(f"unknown tap_impl {tap_impl!r}; expected 'auto', 'einsum', "
                     "'pallas' or 'pallas-interpret'")


@functools.lru_cache(maxsize=4)
def clipmap_axis_coords(quality: str = "high") -> np.ndarray:
    """The clipmap's graded 1D axis coordinates (k,) float32, as the JAX
    package's generator lays them out (verts are a row-major (k, k) grid
    of (x, z) with x fastest; this is its shared axis)."""
    coords = _axis_coords(**CLIPMAP_PRESETS[quality]).astype(np.float32)
    coords.flags.writeable = False
    return coords


def displaced_grid(maps, map_scales: torch.Tensor, coords: torch.Tensor,
                   center_xz: torch.Tensor, camera_pos: torch.Tensor,
                   sampler: str = "gather") -> torch.Tensor:
    """Vertex stage: displaced world positions of the clipmap grid.

    coords: (k,) graded axis; center_xz: (2,) mesh origin. Returns (k, k, 3)
    world positions indexed [z_row, x_col] (water.gdshader:29-38: cascade
    sum x map scales, 150 m falloff).
    """
    gx, gz = torch.meshgrid(coords, coords, indexing="xy")
    world_xz = torch.stack([gx, gz], dim=-1) + center_xz          # (k, k, 2)
    if sampler == "mxu":
        disp = shading.cascade_displacement_grid(
            maps.displacement, map_scales, coords, center_xz, camera_xz=camera_pos[0::2])
    else:
        disp = shading.cascade_displacement(
            maps.displacement, map_scales, world_xz, camera_xz=camera_pos[0::2],
            sampler=sampler)
    return torch.stack([world_xz[..., 0] + disp[..., 0], disp[..., 1],
                        world_xz[..., 1] + disp[..., 2]], dim=-1)


def _grid_sample(grid: torch.Tensor, coords: torch.Tensor, center_xz: torch.Tensor,
                 qx: torch.Tensor, qz: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the displaced (k, k, 3) grid at world (qx, qz),
    interpolating in the mesh PARAMETER domain (queries clamped to the
    footprint)."""
    k = coords.shape[0]
    lx = qx - center_xz[0]
    lz = qz - center_xz[1]
    i = torch.clamp(torch.searchsorted(coords, lx.contiguous()) - 1, 0, k - 2)
    j = torch.clamp(torch.searchsorted(coords, lz.contiguous()) - 1, 0, k - 2)
    x0, x1 = coords[i], coords[i + 1]
    z0, z1 = coords[j], coords[j + 1]
    fx = torch.clamp((lx - x0) / (x1 - x0), 0.0, 1.0)[..., None]
    fz = torch.clamp((lz - z0) / (z1 - z0), 0.0, 1.0)[..., None]
    v00 = grid[j, i]
    v10 = grid[j, i + 1]
    v01 = grid[j + 1, i]
    v11 = grid[j + 1, i + 1]
    return ((v00 * (1 - fx) + v10 * fx) * (1 - fz)
            + (v01 * (1 - fx) + v11 * fx) * fz)


def surface_height(grid: torch.Tensor, coords: torch.Tensor, center_xz: torch.Tensor,
                   x: torch.Tensor, z: torch.Tensor, chop_iters: int = 1):
    """Displaced-surface height under world (x, z): the buoyancy/gameplay
    probe. Fixed-point inversion of the horizontal chop finds the param
    whose displaced xz is (x, z). Returns (height, (param_x, param_z)); the
    param is the fragment UV (water.gdshader:28)."""
    px, pz = x, z
    for _ in range(chop_iters):
        s = _grid_sample(grid, coords, center_xz, px, pz)
        px = px - (s[..., 0] - x)
        pz = pz - (s[..., 2] - z)
    s = _grid_sample(grid, coords, center_xz, px, pz)
    return s[..., 1], (px, pz)


@functools.lru_cache(maxsize=8)
def _uniform_resample_tables(quality: str, uniform_res: int):
    """Static tables mapping the graded clipmap grid onto a UNIFORM (G, G)
    grid over the same footprint: (i0 (G,), f (G,) fractions, origin, cell)
    for one axis (the grid is isotropic)."""
    coords = clipmap_axis_coords(quality)
    g = uniform_res
    u = np.linspace(coords[0], coords[-1], g).astype(np.float32)
    i0 = np.clip(np.searchsorted(coords, u) - 1, 0, len(coords) - 2)
    f = (u - coords[i0]) / (coords[i0 + 1] - coords[i0])
    return (i0.astype(np.int32), np.clip(f, 0.0, 1.0).astype(np.float32),
            float(coords[0]), float((coords[-1] - coords[0]) / (g - 1)))


def uniform_from_graded(grid: torch.Tensor, quality: str, uniform_res: int) -> torch.Tensor:
    """Resample the displaced (k, k, 3) graded grid to (G, G, 3) uniform with
    the static tables (constant-index gathers)."""
    i0, f, _, _ = _on_device(grid.device, _uniform_resample_tables, quality, uniform_res)
    i1 = i0 + 1
    rows = (grid[i0] * (1 - f)[:, None, None]
            + grid[i1] * f[:, None, None])                  # (G, k, 3) over z
    return (rows[:, i0] * (1 - f)[None, :, None]
            + rows[:, i1] * f[None, :, None])               # (G, G, 3)


def _hat_weights(f: torch.Tensor, g: int) -> torch.Tensor:
    """(..., g) dense bilinear hat weights w[i] = max(0, 1 - |f - i|), bf16:
    the JAX package's gather-free sampling rows (kept for reference and
    tests; `_mxu_sample` reads their two nonzero entries)."""
    iota = torch.arange(g, dtype=torch.float32, device=f.device)
    return torch.clamp_min(1.0 - torch.abs(f[..., None] - iota), 0.0).to(torch.bfloat16)


def _hat_taps(f: torch.Tensor):
    """The two nonzero entries of `_hat_weights` at f in [0, g - 1.001]:
    ((i, i + 1) long, (w0, w1) fp32 before rounding)."""
    i = f.long()                              # f >= 0: truncation is floor
    w0 = torch.clamp_min(1.0 - torch.abs(f - i.float()), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(f - (i + 1).float()), 0.0)
    return i, w0, w1


class _MxuTable:
    """A uniform (G, G) or (G, G, C) table sampled with the JAX package's
    "mxu" numbers: table and hat weights rounded to bf16, fp32 sums of the
    nonzero terms (`_mxu_sample`)."""

    def __init__(self, table: torch.Tensor, origin: float, cell: float,
                 center_xz: torch.Tensor):
        self.g = table.shape[0]
        self.flat = table.to(torch.bfloat16).reshape(self.g * self.g, -1)
        self.squeeze = table.ndim == 2
        self.origin, self.cell, self.center_xz = origin, cell, center_xz

    def __call__(self, qx: torch.Tensor, qz: torch.Tensor) -> torch.Tensor:
        g = self.g
        fx = torch.clamp((qx - self.center_xz[0] - self.origin) / self.cell, 0.0, g - 1.001)
        fz = torch.clamp((qz - self.center_xz[1] - self.origin) / self.cell, 0.0, g - 1.001)
        iz, wz0, wz1 = _hat_taps(fz)
        ix, wx0, wx1 = _hat_taps(fx)
        wz0, wz1 = (w.to(torch.bfloat16).float()[..., None] for w in (wz0, wz1))
        wx0, wx1 = (w.to(torch.bfloat16).float()[..., None] for w in (wx0, wx1))
        at = lambda j, i: self.flat[j * g + i].float()
        row0 = wz0 * at(iz, ix) + wz1 * at(iz + 1, ix)
        row1 = wz0 * at(iz, ix + 1) + wz1 * at(iz + 1, ix + 1)
        out = row0 * wx0 + row1 * wx1
        return out[..., 0] if self.squeeze else out


def _mxu_sample(table: torch.Tensor, origin, cell, center_xz: torch.Tensor,
                qx: torch.Tensor, qz: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a uniform (G, G) or (G, G, C) table at world
    (qx, qz) with the "mxu" numbers (bf16 table and weights, fp32 sums)."""
    return _MxuTable(table, origin, cell, center_xz)(qx, qz)


def _uniform_sample(ugrid: torch.Tensor, origin, cell, center_xz: torch.Tensor,
                    qx: torch.Tensor, qz: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the uniform (G, G, C) grid at world (qx, qz):
    arithmetic indices only, fp32."""
    g = ugrid.shape[0]
    fx = torch.clamp((qx - center_xz[0] - origin) / cell, 0.0, g - 1.001)
    fz = torch.clamp((qz - center_xz[1] - origin) / cell, 0.0, g - 1.001)
    i = fx.long()
    j = fz.long()
    ax = (fx - i.float())[..., None]
    az = (fz - j.float())[..., None]
    v00 = ugrid[j, i]
    v10 = ugrid[j, i + 1]
    v01 = ugrid[j + 1, i]
    v11 = ugrid[j + 1, i + 1]
    return ((v00 * (1 - ax) + v10 * ax) * (1 - az)
            + (v01 * (1 - ax) + v11 * ax) * az)


def _pick_nbands(height: int, target: int = 16) -> int:
    """Largest divisor of `height` <= target: the LOD band count (1 disables
    banding)."""
    for nb in range(min(target, height), 1, -1):
        if height % nb == 0:
            return nb
    return 1


@functools.lru_cache(maxsize=32)
def _scale_weights(n_full: int, n_small: int, kind: str = "linear") -> np.ndarray:
    """(n_full, n_small) weights lifting a frame rendered at reduced
    resolution back to output resolution (pixel-center aligned, edges
    clamped): "linear" 2-sparse hat rows, "catrom" 4-sparse Catmull-Rom
    rows (negative lobes; the caller clamps with `_pool3`)."""
    x = (np.arange(n_full) + 0.5) * (n_small / n_full) - 0.5
    w = np.zeros((n_full, n_small), np.float32)
    if kind == "linear":
        lo = np.clip(np.floor(x).astype(np.int64), 0, n_small - 1)
        hi = np.minimum(lo + 1, n_small - 1)
        frac = np.clip(x - lo, 0.0, 1.0).astype(np.float32)
        np.add.at(w, (np.arange(n_full), lo), 1.0 - frac)
        np.add.at(w, (np.arange(n_full), hi), frac)
    elif kind == "catrom":
        b = np.floor(x).astype(np.int64)
        f = (x - b).astype(np.float32)
        f2, f3 = f * f, f * f * f
        taps = ((-1, 0.5 * (-f + 2 * f2 - f3)),
                (0, 0.5 * (2 - 5 * f2 + 3 * f3)),
                (1, 0.5 * (f + 4 * f2 - 3 * f3)),
                (2, 0.5 * (f3 - f2)))
        for off, ww in taps:
            idx = np.clip(b + off, 0, n_small - 1)
            np.add.at(w, (np.arange(n_full), idx), ww)
    else:
        raise ValueError(f"unknown lift kind {kind!r}")
    return w


def _pool3(img: torch.Tensor, op) -> torch.Tensor:
    """3x3 neighborhood reduction of (h, w, ch) with clamped edges (op =
    torch.minimum / torch.maximum): the catrom lift's anti-ringing bound."""
    h, w, _ = img.shape
    p = torch.cat([img[:1], img, img[-1:]], dim=0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
    out = img
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            out = op(out, p[dy:dy + h, dx:dx + w])
    return out


def _lift2d(img: torch.Tensor, row_w: torch.Tensor, col_w: torch.Tensor) -> torch.Tensor:
    """Separable screen-space lift of (h, w, ch) to (H, W, ch) as two fp32
    matrix products with the channel axis folded in."""
    h, w, ch = img.shape
    out_h, out_w = row_w.shape[0], col_w.shape[0]
    a = row_w @ img.reshape(h, w * ch)                      # (out_h, w*ch)
    a = a.reshape(out_h, w, ch).transpose(1, 2).reshape(out_h * ch, w)
    b = a @ col_w.T                                         # (out_h*ch, out_w)
    return b.reshape(out_h, ch, out_w).transpose(1, 2)


@functools.lru_cache(maxsize=32)
def _upsample_weights(n: int, stride: int):
    """Static decimation indices + linear upsample matrix for one axis:
    ~n/stride samples from 0 to n-1 (both ends), the count rounded UP to a
    multiple of 16 so the LOD banding finds a divisor. Returns (indices
    (m,), weights (n, m) fp32) with 2-sparse rows."""
    m = max(2, min(n, -(-n // stride)))
    if m < n:
        m = min(n, -(-m // 16) * 16)
    pos_a = np.unique(np.round(np.linspace(0, n - 1, m)).astype(np.int64))
    w = np.zeros((n, len(pos_a)), np.float32)
    seg = np.clip(np.searchsorted(pos_a, np.arange(n), side="right") - 1,
                  0, len(pos_a) - 2)
    lo, hi = pos_a[seg], pos_a[seg + 1]
    frac = (np.arange(n) - lo) / np.maximum(hi - lo, 1)
    w[np.arange(n), seg] = 1.0 - frac
    w[np.arange(n), seg + 1] = frac
    w[pos_a] = 0.0
    w[pos_a, np.arange(len(pos_a))] = 1.0
    return pos_a, w


@functools.lru_cache(maxsize=8)
def _fan_tau(tau_near: float, far: float, tau_res: int) -> np.ndarray:
    """The fan march's log-spaced horizontal distances (static)."""
    return np.geomspace(tau_near, far, tau_res, dtype=np.float32)


def _fan_select(sample_h, cam, d, t0, t1, marchable,
                far: float, phi_res: int, tau_res: int, rows_group: int,
                frame_height: int, heading, rel_range,
                tau_near: float = 0.25):
    """Polar fan bracket: the whole march reduced to one table and a compare.

    Every pixel's ground track is a straight ray from the camera's xz, so
    the heightfield along all candidate march positions lives on a (heading
    phi x log-distance tau) fan table sampled once per frame. Each pixel's
    depth profile is the 2-tap hat interpolation of that table across phi
    (amortized over `rows_group`-row groups, in fp32), and the bracket is a
    first-crossing min over tau. The caller re-tests the returned (t_lo,
    t_hi] segment on the fine table. `heading`, `rel_range` and
    `frame_height` come from band-independent quantities so a `rows` band
    builds the same fan as the full frame.

    Returns (found, t_lo, t_hi) in ray-parameter units.
    """
    hgt, wid = d.shape[:2]
    dxz = torch.clamp_min(torch.sqrt(d[..., 0] ** 2 + d[..., 2] ** 2), 1e-6)
    s = d[..., 1] / dxz                       # dy per horizontal meter
    ux, uz = d[..., 0] / dxz, d[..., 2] / dxz
    mx, mz = heading
    rel = torch.atan2(ux * mz - uz * mx, ux * mx + uz * mz)
    lo_a, hi_a = rel_range
    dphi = (hi_a - lo_a) / (phi_res - 1) + 1e-9
    ang = lo_a + torch.arange(phi_res, dtype=torch.float32, device=d.device) * dphi
    ca, sa = torch.cos(ang), torch.sin(ang)
    fux, fuz = mx * ca + mz * sa, mz * ca - mx * sa
    tau = _on_device(d.device, _fan_tau, tau_near, far, tau_res)
    hfan = sample_h(cam[0] + fux[:, None] * tau[None, :],
                    cam[2] + fuz[:, None] * tau[None, :])   # (phi, tau)

    # rows_group is calibrated at 720 rows; scale with the FULL frame
    # height, then take the largest divisor of the local row count
    g_target = max(1, (rows_group * frame_height) // 720)
    g = 1
    for cand_g in range(min(g_target, hgt), 0, -1):
        if hgt % cand_g == 0:
            g = cand_g
            break
    a = torch.clamp((rel - lo_a) / dphi, 0.0, float(phi_res - 1))
    ag = a.reshape(hgt // g, g, wid).mean(dim=1)            # (H/g, W)
    # the profile: the two nonzero hat weights across phi, in full fp32
    # (near-grazing crossings are height-sensitive)
    i0 = torch.clamp_max(ag.long(), phi_res - 2)
    w0 = torch.clamp_min(1.0 - torch.abs(ag - i0.float()), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(ag - (i0 + 1).float()), 0.0)
    ratio = float(np.exp(-np.log(far / tau_near) / (tau_res - 1)))
    # the first crossing along each pixel's profile: one kernel on the card,
    # the broadcast chain over (H/g, g, W, J) on the CPU
    return fan.fan_bracket(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, ratio)


def camera_rays(width: int, height: int, pitch_deg, yaw_deg, fov_deg,
                row_offset=0, row_count: int | None = None,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Pixel ray directions (H, W, 3) for the FlyCamera basis convention.

    `row_offset`/`row_count` select a horizontal band of the full frame;
    `row_offset` may be a 0-d tensor, `row_count` is static. Pose arguments
    may be Python numbers or 0-d tensors (on `device`). Defaults to the card
    and raises without one; pass device="cpu" to stay on the CPU.
    """
    device = require_device(device)
    rows = height if row_count is None else row_count
    pitch = torch.deg2rad(_scalar(pitch_deg, device))
    tan_half = torch.tan(torch.deg2rad(_scalar(fov_deg, device)) / 2)
    xs = (torch.arange(width, dtype=torch.float32, device=device) / width * 2 - 1) * tan_half
    ys = ((0.5 - (row_offset + torch.arange(rows, dtype=torch.float32, device=device)) / height)
          * 2 * tan_half * (height / width))
    dirx, diry = torch.meshgrid(xs, ys, indexing="xy")
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    d = torch.stack([dirx, diry * cp + sp, -diry * sp + cp], dim=-1)
    yaw = torch.deg2rad(_scalar(yaw_deg, device))
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    d = torch.stack([cy * d[..., 0] - sy * d[..., 2], d[..., 1],
                     sy * d[..., 0] + cy * d[..., 2]], dim=-1)
    return d / shading._norm(d)


def _safe(dy: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """dy with |dy| < eps moved to +-eps (sign kept, zero counts positive)."""
    return torch.where(torch.abs(dy) < eps, torch.where(dy < 0, -eps, eps), dy)


def march_window(cam: torch.Tensor, d: torch.Tensor, grid: torch.Tensor,
                 coords: torch.Tensor, center_xz: torch.Tensor, far: float):
    """Per-ray march window (t0, t1, marchable) against the displaced grid.

    Enter at the crest ceiling (if above it) and the mesh's horizontal
    bounding box (a camera outside the footprint must not sample before the
    box); leave at the trough floor, the box exit or `far`. Rays with an
    empty window are not marchable and get the dummy window (0, 1).
    """
    y_max = grid[..., 1].max() + 0.1
    y_min = grid[..., 1].min() - 0.1
    dy = d[..., 1]
    eps = 1e-6
    safe_dy = _safe(dy, eps)
    above = cam[1] > y_max
    t_enter = torch.where(above, (y_max - cam[1]) / safe_dy, 0.0)
    t_enter = torch.where(above & (dy >= 0), math.inf, torch.clamp_min(t_enter, 0.0))
    t_floor = torch.where(dy < 0, (y_min - cam[1]) / safe_dy, math.inf)
    lo_x, hi_x = coords[0] + center_xz[0], coords[-1] + center_xz[0]
    lo_z, hi_z = coords[0] + center_xz[1], coords[-1] + center_xz[1]

    def slab_t(o, dd, lo, hi):
        sd = torch.where(torch.abs(dd) < eps, eps, dd)
        ta = (lo - o) / sd
        tb = (hi - o) / sd
        return torch.minimum(ta, tb), torch.maximum(ta, tb)
    enter_x, exit_x = slab_t(cam[0], d[..., 0], lo_x, hi_x)
    enter_z, exit_z = slab_t(cam[2], d[..., 2], lo_z, hi_z)
    t_enter = torch.maximum(t_enter, torch.maximum(enter_x, enter_z))
    t_box = torch.minimum(exit_x, exit_z)
    t_end = torch.clamp_max(torch.minimum(t_floor, t_box), far)
    marchable = t_enter < t_end
    return (torch.where(marchable, t_enter, 0.0), torch.where(marchable, t_end, 1.0),
            marchable)


def render_ocean_geometry(
    maps,                       # OceanMaps (channel-first planes)
    map_scales: torch.Tensor,   # (C, 4)
    quality: str = "high",      # clipmap grading (water.gd:43-46)
    width: int = 960,
    height: int = 540,
    camera_pos=(0.0, 12.0, 0.0),
    pitch_deg=-12.0,
    yaw_deg=0.0,
    fov_deg=70.0,
    center_xz=None,             # mesh origin; None -> snapped under camera
    light_dir=(0.3, 0.55, 0.9),
    environment: bool = False,
    march_steps: int = 40,
    bisect_steps: int = 8,
    chop_iters: int = 1,
    march_chop_iters: int = 0,
    far: float = 1600.0,
    accel: str = "uniform",     # "uniform" (fast march grid) | "exact"
    uniform_res: int = 512,
    sampler: str = "auto",      # "auto" | "mxu" | "gather" (uniform accel)
    march_res: int = 256,       # mxu march-table resolution (2 m cells)
    bracket_res: int = 0,       # coarse table for the BRACKET march (0=off)
    invert_res: int = 0,        # chop-only table for the UV inversion (0=off)
    march_impl: str = "auto",   # "auto" | "fan" | "xla" | "pallas"
    fan_phi: int = 256,         # fan march: heading-axis resolution
    fan_tau: int = 320,         # fan march: log-depth-axis resolution
    fan_rows: int = 8,          # fan march: rows sharing one profile
    gradient_lod: bool = True,  # screen-space mip LOD for the gradient taps
    tap_impl: str = "auto",     # "auto" | "einsum" | "pallas"[-interpret]
    lod_bands: int = 16,        # max horizontal LOD bands (must divide H)
    lod_levels: int = 4,        # max mip pyramid depth for the LOD taps
    lod_bias: float = 1.0,      # >1 = coarser mips (speed/detail tradeoff)
    shade_res: int = 1,         # gradient taps every s-th pixel, upsampled
    render_scale: int = 1,      # dynamic resolution: render at 1/s, upsample
    rows=None,                  # (row_offset, row_count) band of the frame
    lift: str = "catrom",       # render_scale filter: "catrom" | "linear"
    _debug_stage=None,          # profiling: "march" | "uv" | "grad" early out
    **shade_kwargs,
) -> torch.Tensor:
    """Perspective render of the DISPLACED clipmap mesh -> (H, W, 3) RGB.

    The JAX package's signature and semantics (its geometry.py:492-585):
    rays march the displaced surface inside the mesh footprint and fall
    back to the flat y=0 plane beyond it.

    - sampler: "auto" is "mxu" on a CUDA device (the JAX package's TPU
      numbers) and "gather" on the CPU.
    - march_impl: "auto" is the polar fan march on accel="uniform", the
      per-pixel bracket rounds ("xla") on "exact"; "pallas" runs the
      heightfield-march kernel (`ops/march.py`: CUDA on the card, its
      plain version on the CPU; needs uniform/mxu and no march chop).
    - tap_impl: see `_resolve_tap_impl`; under "mxu" with gradient LOD the
      gradient taps are the gradient-tap kernel's (`ops/tap.py`).
    - bracket_res / invert_res / shade_res / render_scale + lift / rows:
      the two-level march table, the 2-channel chop-inversion table, the
      decimated gradient taps, dynamic resolution with the catrom (or
      linear) lift, and a horizontal band of the frame.
    - _debug_stage: "march" -> (t, hit) (H, W, 2), "uv" -> (H, W, 2),
      "grad" -> the gradient the full render shades, (H, W, 3).
    """
    if _debug_stage not in (None, "march", "uv", "grad"):
        raise ValueError(f"unknown _debug_stage {_debug_stage!r}; expected "
                         "None, 'march', 'uv' or 'grad'")
    if _debug_stage is not None and render_scale > 1:
        raise ValueError("_debug_stage is a profiling hook for the internal "
                         "render; call it with render_scale=1")
    if render_scale > 1:
        # rebuild the recursive call's kwargs by signature name: a renamed
        # or added parameter raises KeyError instead of going missing.
        # Must stay the first statement block so locals() only holds params.
        frame = locals()
        call = {name: frame[name]
                for name in inspect.signature(render_ocean_geometry).parameters
                if name not in ("render_scale", "shade_kwargs")}
        s = render_scale
        if width % s or height % s:
            raise ValueError(f"render_scale={s} needs width/height divisible by it "
                             f"(got {width}x{height})")
        out_h = height
        if rows is not None:
            off, cnt = rows
            if isinstance(cnt, int) and cnt % s:
                raise ValueError(f"render_scale={s} needs the rows count divisible by it "
                                 f"(got {cnt})")
            if isinstance(off, int) and off % s:
                raise ValueError(
                    f"render_scale={s} needs the rows offset divisible by it (got offset "
                    f"{off}); an offset floored by //{s} would render a band shifted by up "
                    "to s-1 rows")
            call["rows"] = (off // s, cnt // s)
            out_h = cnt
        call["width"], call["height"] = width // s, height // s
        img = render_ocean_geometry(**call, **shade_kwargs)
        dev = img.device
        row_w = _on_device(dev, _scale_weights, out_h, out_h // s, lift)
        col_w = _on_device(dev, _scale_weights, width, width // s, lift)
        out = _lift2d(img, row_w, col_w)
        if lift == "catrom":
            # anti-ringing: clamp each output pixel to its 3x3 internal-frame
            # neighborhood extremes, nearest-lifted (integer scale)
            def near(x):
                h, w, ch = x.shape
                return x[:, None, :, None].expand(h, s, w, s, ch).reshape(h * s, w * s, ch)
            out = torch.minimum(torch.maximum(out, near(_pool3(img, torch.minimum))),
                                near(_pool3(img, torch.maximum)))
        return out

    dev = maps.displacement.device
    cam = _vec(camera_pos, dev)
    row_offset, local_h = (0, height) if rows is None else rows
    if center_xz is None:
        # clipmap follow: mesh snapped to whole tiles under the camera
        center_xz = torch.ceil(cam[0::2])
    else:
        center_xz = _vec(center_xz, dev)
    coords = _on_device(dev, clipmap_axis_coords, quality)
    d = camera_rays(width, height, pitch_deg, yaw_deg, fov_deg,
                    row_offset=row_offset, row_count=local_h, device=dev)
    light = _vec(light_dir, dev)
    light = light / shading._norm(light)

    if sampler == "auto":
        sampler = "mxu" if dev.type == "cuda" else "gather"
    if march_impl == "auto":
        march_impl = "fan" if accel == "uniform" else "xla"
    grid = displaced_grid(maps, map_scales, coords, center_xz, cam, sampler=sampler)
    if accel == "uniform" and sampler == "mxu":
        ugrid = uniform_from_graded(grid, quality, uniform_res)
        _, _, origin, cell = _uniform_resample_tables(quality, uniform_res)
        mheight = uniform_from_graded(grid, quality, march_res)[..., 1]
        _, _, morigin, mcell = _uniform_resample_tables(quality, march_res)
        sample = _MxuTable(ugrid, origin, cell, center_xz)
        sample_h = _MxuTable(mheight, morigin, mcell, center_xz)
        if bracket_res and bracket_res < march_res:
            # two-level march: bracket steps on a coarser table, refinement
            # and the landed hit on the fine march_res table
            bheight = uniform_from_graded(grid, quality, bracket_res)[..., 1]
            _, _, borigin, bcell = _uniform_resample_tables(quality, bracket_res)
            sample_hb = _MxuTable(bheight, borigin, bcell, center_xz)
        else:
            sample_hb = sample_h
    elif accel == "uniform":
        ugrid = uniform_from_graded(grid, quality, uniform_res)
        _, _, origin, cell = _uniform_resample_tables(quality, uniform_res)
        uheight = ugrid[..., 1:2]   # single-channel: the march's hot grid

        def sample(qx, qz):
            return _uniform_sample(ugrid, origin, cell, center_xz, qx, qz)

        def sample_h(qx, qz):
            return _uniform_sample(uheight, origin, cell, center_xz, qx, qz)[..., 0]

        if bracket_res and bracket_res < uniform_res:
            bheight = uniform_from_graded(grid, quality, bracket_res)[..., 1:2]
            _, _, borigin, bcell = _uniform_resample_tables(quality, bracket_res)

            def sample_hb(qx, qz):
                return _uniform_sample(bheight, borigin, bcell, center_xz, qx, qz)[..., 0]
        else:
            sample_hb = sample_h
    else:
        def sample(qx, qz):
            return _grid_sample(grid, coords, center_xz, qx, qz)

        def sample_h(qx, qz):
            return sample(qx, qz)[..., 1]

        sample_hb = sample_h

    def height_at(x, z, iters=chop_iters, coarse=False):
        """Surface height + inverted param under world (x, z); iters=0
        samples the height channel only, coarse=True the bracket table."""
        if iters == 0:
            return (sample_hb if coarse else sample_h)(x, z), (x, z)
        px, pz = x, z
        for _ in range(iters):
            s = sample(px, pz)
            px = px - (s[..., 0] - x)
            pz = pz - (s[..., 2] - z)
        s = sample(px, pz)
        return s[..., 1], (px, pz)

    t0, t1, marchable = march_window(cam, d, grid, coords, center_xz, far)
    dy = d[..., 1]
    safe_dy = _safe(dy)

    def below_at(t, coarse=False):
        p = cam + t[..., None] * d
        h, _ = height_at(p[..., 0], p[..., 2], iters=march_chop_iters, coarse=coarse)
        return p[..., 1] < h

    def bracket(lo, hi, m, valid, coarse=False):
        """First below-surface crossing among m samples of (lo, hi]."""
        seg = (hi - lo) / m
        slices = []
        for idx in range(m):
            t = lo + (idx + 1.0) * seg
            p = cam + t[..., None] * d
            h, _ = height_at(p[..., 0], p[..., 2], iters=march_chop_iters, coarse=coarse)
            slices.append(p[..., 1] < h)
        below = torch.stack(slices) & valid[None]
        hit = below.any(dim=0)
        # torch's argmax takes no bool; the first maximal index, as in JAX
        first = torch.argmax(below.to(torch.uint8), dim=0).float()
        t_first = lo + (first + 1.0) * seg
        return (hit,
                torch.where(hit, t_first - seg, lo),
                torch.where(hit, t_first, hi))

    if march_impl == "fan":
        if accel != "uniform":
            raise ValueError("march_impl='fan' requires the uniform-accel path")
        # band-independent fan frame: center heading from yaw, heading range
        # from the FULL frame's corner rays
        yaw_r = torch.deg2rad(_scalar(yaw_deg, dev))
        mx, mz = -torch.sin(yaw_r), torch.cos(yaw_r)
        corner = [camera_rays(width, height, pitch_deg, yaw_deg, fov_deg,
                              row_offset=r, row_count=1, device=dev)
                  for r in (0, height - 1)]
        dc = torch.cat([torch.stack([c[:, 0], c[:, -1]], dim=1) for c in corner])  # (2, 2, 3)
        dn = torch.clamp_min(torch.sqrt(dc[..., 0] ** 2 + dc[..., 2] ** 2), 1e-6)
        cux = dc[..., 0] / dn
        cuz = dc[..., 2] / dn
        crel = torch.atan2(cux * mz - cuz * mx, cux * mx + cuz * mz)
        span = torch.clamp_min(torch.abs(crel).max(), 1e-3)
        fsel, flo, fhi = _fan_select(sample_h, cam, d, t0, t1, marchable,
                                     far, fan_phi, fan_tau, fan_rows,
                                     height, (mx, mz), (-span, span))
        # re-test the fan's (t_lo, t_hi] segment on the fine world table; a
        # bracket the fine table refutes demotes to the far-field miss path
        found, lo, hi = bracket(flo, fhi, max(2, bisect_steps - 2), fsel)
    elif march_impl == "pallas":
        if not (accel == "uniform" and sampler == "mxu" and march_chop_iters == 0):
            raise ValueError("march_impl='pallas' requires the uniform/mxu/no-march-chop path")
        from ..ops.march import march_heightfield
        found, lo, hi = march_heightfield(
            mheight, d, t0, t1, marchable, cam, center_xz,
            origin=morigin, cell=mcell, march_steps=march_steps,
            refine_rounds=max(1, bisect_steps // 3))
    elif march_impl == "xla":
        two_level = sample_hb is not sample_h
        # found0 always tests the FINE table: camera already under a crest
        found0 = below_at(t0) & marchable
        found, lo, hi = bracket(t0, t1, march_steps, marchable & ~found0,
                                coarse=two_level)
        # found0 pixels hit AT the window start: a degenerate (t0, t0)
        # bracket is a fixed point of the refinement below
        lo = torch.where(found0, t0, lo)
        hi = torch.where(found0, t0, hi)
        found = found | found0
        # invariant: hi is below the surface for found pixels; two-level:
        # coarse hits the fine table refutes demote to the far-field path
        for ri in range(max(1, bisect_steps // 3)):
            rhit, lo, hi = bracket(lo, hi, 8, found)
            if ri == 0 and two_level:
                found = found0 | rhit
    else:
        raise ValueError(f"unknown march_impl {march_impl!r}; expected 'auto', 'fan', "
                         "'xla' or 'pallas'")
    t_hit = 0.5 * (lo + hi)

    # flat far-field: rays that miss the mesh but still descend hit y=0
    t_flat = torch.where(dy < 0, -cam[1] / safe_dy, math.inf)
    use_flat = ~found & (dy < 0) & (t_flat > 0)
    t_hit = torch.where(found, t_hit, t_flat)
    hit = found | use_flat

    t_safe = torch.where(hit, t_hit, 1.0)
    if _debug_stage == "march":
        return torch.stack([t_safe, hit.float()], dim=-1)
    p = cam + t_safe[..., None] * d
    # fragment UV = pre-displacement param (water.gdshader:28)
    if (invert_res and invert_res < uniform_res and chop_iters > 0
            and accel == "uniform" and sampler == "mxu"):
        # the inversion consumes only the horizontal chop channels: a
        # 2-channel table at invert_res
        igrid = uniform_from_graded(grid, quality, invert_res)[..., 0::2]
        _, _, iorg, icel = _uniform_resample_tables(quality, invert_res)
        isample = _MxuTable(igrid, iorg, icel, center_xz)
        ux, uz = p[..., 0], p[..., 2]
        for _ in range(chop_iters):
            s = isample(ux, uz)
            ux = ux - (s[..., 0] - p[..., 0])
            uz = uz - (s[..., 1] - p[..., 2])
    else:
        _, (ux, uz) = height_at(p[..., 0], p[..., 2])
    ux = torch.where(found, ux, p[..., 0])
    uz = torch.where(found, uz, p[..., 2])
    uv = torch.stack([ux, uz], dim=-1)
    if _debug_stage == "uv":
        return uv

    dist = t_safe
    # shade_res > 1: the gradient taps on a decimated screen grid, linearly
    # upsampled (gradients are smooth fields); shading stays per pixel
    if shade_res > 1:
        rows_g, row_w = _on_device(dev, _upsample_weights, local_h, shade_res)
        cols_g, col_w = _on_device(dev, _upsample_weights, width, shade_res)
        uv_g = uv.index_select(0, rows_g).index_select(1, cols_g)
        dist_g = dist.index_select(0, rows_g).index_select(1, cols_g)
        hit_g = hit.index_select(0, rows_g).index_select(1, cols_g)
        h_g, w_g = rows_g.shape[0], cols_g.shape[0]
    else:
        uv_g, dist_g, hit_g = uv, dist, hit
        h_g, w_g = local_h, width
    lod = gradient_lod and sampler == "mxu"
    nb = _pick_nbands(h_g, lod_bands) if lod else 1
    if lod and nb == 1 and h_g > 16:
        # banding needs a divisor of the tap-row count; nb=1 silently runs
        # every gradient tap at mip level 0
        warnings.warn(
            f"gradient LOD banding disabled: no divisor of {h_g} tap rows "
            f"<= lod_bands={lod_bands}; all gradient taps run at full "
            "resolution (pick a height whose tap-row count has small "
            "divisors)", RuntimeWarning, stacklevel=2)
    if nb > 1:
        # per-band per-cascade mip levels from the band's minimum hit
        # distance; all-sky bands skip their taps
        pyr = shading.normal_gradient_pyramid(maps.normal, levels=lod_levels)
        theta_pix = (2.0 * torch.tan(torch.deg2rad(_scalar(fov_deg, dev)) / 2)
                     / width) * shade_res
        lev = shading.gradient_band_levels(
            dist_g.reshape(nb, -1), hit_g.reshape(nb, -1), map_scales,
            theta_pix, maps.normal.shape[-1], len(pyr), bias=lod_bias)
        grad = shading.cascade_gradient_lod(
            pyr, map_scales, uv_g.reshape(nb, -1, 2), lev,
            tap_impl=_resolve_tap_impl(tap_impl, dev))
        grad = grad.reshape(h_g, w_g, 3)
    else:
        grad = shading.cascade_gradient(maps.normal, map_scales, uv_g, sampler=sampler)
    if shade_res > 1:
        grad = _lift2d(grad, row_w, col_w)
    if _debug_stage == "grad":
        return grad
    rgb = shading.shade(grad, p[..., 1], -d, light, dist, **shade_kwargs)
    rgb = torch.where(hit[..., None], rgb, shading.sky_color(d, light))
    if environment:
        rgb = shading.apply_environment(rgb, dist, hit)
    return torch.clamp(rgb, 0.0, 1.0)
