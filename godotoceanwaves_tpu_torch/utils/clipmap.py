"""Clipmap mesh builder (NumPy), and the camera-follow tile snap.

Copy of the JAX package's `utils/clipmap.py` NumPy twin: the reference's
pre-baked clipmap OBJ assets (C19: clipmap_high/low, a 512 x 512 m graded
plane) generated procedurally. The port builds no native code:
`build_clipmap` is the NumPy twin under the JAX package's name and
signature (the JAX package's `native/clipmap.cpp` computes the same
double-precision ladder), and the tests pin it, and
`models.geometry.clipmap_axis_coords`, to the JAX functions.
"""
from __future__ import annotations

import numpy as np


def _axis_coords(levels: int, center_res: int, ring_cells: int, extent: float):
    span_units = center_res * 0.5
    scale = 1.0
    for _ in range(levels):
        scale *= 2.0
        span_units += ring_cells * scale
    step0 = (extent * 0.5) / span_units

    pos = []
    x, s = 0.0, step0
    for _ in range(center_res // 2):
        x += s
        pos.append(x)
    for _ in range(levels):
        s *= 2.0
        for _ in range(ring_cells):
            x += s
            pos.append(x)
    return np.asarray([-v for v in pos[::-1]] + [0.0] + pos)


def build_clipmap_numpy(levels: int = 4, center_res: int = 64,
                        ring_cells: int = 16, extent: float = 512.0):
    """Graded clipmap plane: (verts (V, 2) f32, idx (T, 3) u32)."""
    coords = _axis_coords(levels, center_res, ring_cells, extent)
    k = len(coords)
    xx, zz = np.meshgrid(coords, coords)
    verts = np.stack([xx.ravel(), zz.ravel()], -1).astype(np.float32)
    j, i = np.meshgrid(np.arange(k - 1), np.arange(k - 1), indexing="ij")
    a = (j * k + i).ravel()
    b = a + 1
    c = a + k
    d = c + 1
    idx = np.stack([np.stack([a, c, b], -1), np.stack([b, c, d], -1)], 1)
    return verts, idx.reshape(-1, 3).astype(np.uint32)


def build_clipmap(levels: int = 4, center_res: int = 64, ring_cells: int = 16,
                  extent: float = 512.0, prefer_native: bool = True):
    """Graded clipmap plane (the reference's 512 m mesh, water.gd:8-9):
    (verts (V, 2) float32 xz, indices (T, 3) uint32). `prefer_native` is
    accepted for the JAX package's callers; the port always builds the
    mesh in NumPy."""
    return build_clipmap_numpy(levels, center_res, ring_cells, extent)


def snap_to_tile(camera_xz, tile_size: float = 1.0):
    """Clipmap-follow: snap the mesh origin to the camera's tile (main.gd:32-37)."""
    camera_xz = np.asarray(camera_xz, np.float64)
    return np.ceil(camera_xz / tile_size) * tile_size
