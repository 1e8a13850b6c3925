"""Bit-exact integer-hash RNG and Box-Muller transform (PyTorch port of `ops/rng.py`).

The reference seeds its initial spectrum with an xxHash32-style hash per texel
(spectrum_compute.glsl:34-41) and a Box-Muller transform (glsl:44-49). The
hash must stay bit-exact. uint32 arithmetic is only partly covered on CUDA
tensors, so words are held in int64 and masked to 32 bits; products are split
into 16-bit halves so that no int64 product overflows.
"""
from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_MASK31 = 0x7FFFFFFF
# float(0x7FFFFFFF) rounds to 2^31 in fp32, as GLSL's `/ float(0x7FFFFFFF)` does
_INV_U31 = float(2 ** 31)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret integers as uint32 words (GLSL's uvec2(int) cast), in int64."""
    return x.to(torch.int64) & _MASK32


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 words `a` and constant `b`."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _unit(word: torch.Tensor) -> torch.Tensor:
    return ((word >> 1) & _MASK31).to(torch.float32) / _INV_U31


def hash_uvec2(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xxHash32-style hash of a uvec2 -> two uniforms in [0, 1]
    (spectrum_compute.glsl:34-41)."""
    x, y = _u32(x), _u32(y)
    h32 = (y + 374761393 + _mul32(x, 3266489917)) & _MASK32
    h32 = _mul32(h32 ^ (h32 >> 15), 2246822519)
    h32 = _mul32(h32 ^ (h32 >> 13), 3266489917)
    n = h32 ^ (h32 >> 16)
    return _unit(n), _unit(_mul32(n, 48271))


def hash32_uvec2(px: torch.Tensor, py: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """uvec2 -> three uniforms in [0, 1]; the spray particle hash
    (sea_spray_particle.gdshader:31-38)."""
    px, py = _u32(px), _u32(py)
    qx = _mul32((px >> 1) ^ py, 1103515245)
    qy = _mul32((py >> 1) ^ px, 1103515245)
    h32 = _mul32(qx ^ (qy >> 3), 1103515245)
    n = h32 ^ (h32 >> 16)
    return _unit(n), _unit(_mul32(n, 16807)), _unit(_mul32(n, 48271))


def gaussian_pair(u0: torch.Tensor, u1: torch.Tensor) -> torch.Tensor:
    """Box-Muller: two uniforms -> one complex standard normal sample
    (spectrum_compute.glsl:44-49), complex64."""
    # Floor u0 away from 0: the hash emits u0 == 0 with p = 2^-31 per texel,
    # where log(0) would smear an inf amplitude across the cascade's maps.
    u0 = torch.clamp_min(u0, 1.1754944e-38)  # smallest normal fp32
    r = torch.sqrt(-2.0 * torch.log(u0))
    theta = (2.0 * math.pi) * u1
    return torch.complex(r * torch.cos(theta), r * torch.sin(theta))
