"""Wavenumber grids and layout helpers (PyTorch port of `ops/grid.py`).

A field is indexed ``field[..., y, x]``: the last axis is the texel x
coordinate (spectrum_modulate.glsl:52). The k-grid is centered,
k = (id - N/2) * 2*pi / tile_length (spectrum_compute.glsl:104-105), so the
spatial ifftshift is the (-1)^(x+y) sign trick (fft_unpack.glsl:37-38).
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def scalar_div(num: float, den: torch.Tensor) -> torch.Tensor:
    """fp32 `num / den` rounded once, as jnp does it.

    `float / tensor` in PyTorch is `den.reciprocal() * num`, two roundings.
    The numerator is filled on den's device: a tensor built from the Python
    number would be a host-to-device copy that stalls the host.
    """
    return torch.full_like(den, num, dtype=torch.float32) / den


def k_grid(map_size: int, tile_length_x: torch.Tensor, tile_length_y: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered wavenumber grids (kx, ky), each (map_size, map_size) float32."""
    dev = tile_length_x.device
    idx = torch.arange(map_size, dtype=torch.float32, device=dev) - map_size * 0.5
    kx = (idx[None, :] * scalar_div(TWO_PI, tile_length_x)).expand(map_size, map_size)
    ky = (idx[:, None] * scalar_div(TWO_PI, tile_length_y)).expand(map_size, map_size)
    return kx, ky


def sign_shift(map_size: int, device: torch.device | str = "cpu", rows: int | None = None,
               y_offset: int = 0) -> torch.Tensor:
    """(-1)^(x+y) grid, the ifftshift of the centered spectrum (fft_unpack.glsl:37-38):
    (map_size, map_size), or rows y_offset .. y_offset + rows - 1 of it."""
    i = torch.arange(map_size, device=device)
    y = i if rows is None else torch.arange(rows, device=device) + y_offset
    odd = (y[:, None] + i[None, :]) % 2
    return 1.0 - 2.0 * odd.to(torch.float32)


def negate_wavenumber(field: torch.Tensor) -> torch.Tensor:
    """Map field[id] -> field[mod(-id, N)] over the last two axes (flip + roll)."""
    return torch.roll(torch.flip(field, dims=(-2, -1)), shifts=(1, 1), dims=(-2, -1))
