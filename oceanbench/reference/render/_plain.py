"""What the frozen render copy took from the program, as plain code.

`keep` is the identity (the copy captures no CUDA graph), `require_device`
resolves a device without the program's checks, and `_axis_coords` and
`hash32_uvec2` are copies of the program's clipmap ladder and spray hash.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_MASK31 = 0x7FFFFFFF
_INV_U31 = float(2 ** 31)   # float(0x7FFFFFFF) rounds to 2^31 in fp32, as in GLSL


def keep(value):
    return value


def require_device(device) -> torch.device:
    return torch.device(device)


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


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK32


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32, in 16-bit halves so that no int64 product overflows."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _unit(word: torch.Tensor) -> torch.Tensor:
    return ((word >> 1) & _MASK31).to(torch.float32) / _INV_U31


def hash32_uvec2(px: torch.Tensor, py: torch.Tensor):
    """uvec2 -> three uniforms in [0, 1] (sea_spray_particle.gdshader:31-38)."""
    px, py = _u32(px), _u32(py)
    qx = _mul32((px >> 1) ^ py, 1103515245)
    qy = _mul32((py >> 1) ^ px, 1103515245)
    h32 = _mul32(qx ^ (qy >> 3), 1103515245)
    n = h32 ^ (h32 >> 16)
    return _unit(n), _unit(_mul32(n, 16807)), _unit(_mul32(n, 48271))
