"""Unpack the IFFT'd layers into displacement/normal maps + persistent foam
(PyTorch port of `ops/unpack.py`, transcribing fft_unpack.glsl):

  - ifftshift via sign_shift = (-1)^(x+y)                    (glsl:37-38)
  - displacement = (hx, hy, hz) * sign_shift                 (glsl:45-51)
  - Jacobian J = (1+dhx_dx)(1+dhz_dz) - dhz_dx^2             (glsl:58)
  - foam_factor = -min(0, J - whitecap)                      (glsl:59)
  - persistent foam: clamp(foam*e^{-decay} + factor*grow, 0, 1)  (glsl:60-64)
  - normal map = (dhy_dx/(1+|dhx_dx|), dhy_dz/(1+|dhz_dz|), dhx_dx, foam)

Foam stays fp32 whatever the map dtype; maps are cast once, at the end.
"""
from __future__ import annotations

import torch

from . import grid


def unpack_planes(
    fields: torch.Tensor,      # (..., 4, 2, rows, N) float32 — IFFT'd layer planes
    foam_prev: torch.Tensor,   # (..., rows, N) float32
    whitecap,                  # scalars broadcastable to (..., N, N)
    foam_grow_rate,
    foam_decay_rate,
    pre_shifted: bool = True,
    map_dtype: torch.dtype = torch.float32,
    y_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (displacement (..., 3, rows, N), normal (..., 4, rows, N),
    foam fp32).

    Leading dimensions are a cascade batch; pass per-cascade scalars shaped
    (C, 1, 1). The block holds texel rows y_offset .. y_offset + rows - 1
    (a row shard), which sets the (-1)^(x+y) sign when not pre_shifted.
    """
    rows, n = fields.shape[-2], fields.shape[-1]
    sign = 1.0 if pre_shifted else grid.sign_shift(n, fields.device, rows, y_offset)
    hx = fields[..., 0, 0, :, :] * sign
    hy = fields[..., 0, 1, :, :] * sign
    hz = fields[..., 1, 0, :, :] * sign
    dhy_dx = fields[..., 1, 1, :, :] * sign
    dhy_dz = fields[..., 2, 0, :, :] * sign
    dhx_dx = fields[..., 2, 1, :, :] * sign
    dhz_dz = fields[..., 3, 0, :, :] * sign
    dhz_dx = fields[..., 3, 1, :, :] * sign

    displacement = torch.stack([hx, hy, hz], dim=-3)

    jacobian = (1.0 + dhx_dx) * (1.0 + dhz_dz) - dhz_dx * dhz_dx
    foam_factor = -torch.clamp_max(jacobian - whitecap, 0.0)
    foam = foam_prev * torch.exp(-foam_decay_rate) + foam_factor * foam_grow_rate
    foam = torch.clamp(foam, 0.0, 1.0)

    normal = torch.stack([
        dhy_dx / (1.0 + torch.abs(dhx_dx)),
        dhy_dz / (1.0 + torch.abs(dhz_dz)),
        dhx_dx,
        foam,
    ], dim=-3)
    return displacement.to(map_dtype), normal.to(map_dtype), foam
