"""Time modulation + derivative computation + Hermitian packing
(PyTorch port of `ops/modulate.py`).

Per texel (spectrum_modulate.glsl:53-89):

  h(k, t) = h0(k) e^{i w(k) t} + conj(h0(-k)) e^{-i w(k) t}

and the eight real fields are packed two per complex layer (glsl:84-89):

  L0 = hx     + i*hy       L1 = hz     + i*dhy_dx
  L2 = dhy_dz + i*dhx_dx   L3 = dhz_dz + i*dhz_dx

The reference's `.yx` k-component swizzle (glsl:77-82, docs/PARITY.md) is
kept for output parity.
"""
from __future__ import annotations

import torch

from . import grid, spectra


def modulate_planes(
    h0: torch.Tensor,        # (..., 2, rows, N) float32 — (Re, Im) of h0(k)
    h0nc: torch.Tensor,      # (..., 2, rows, N) float32 — (Re, Im) of conj(h0(-k))
    tile_length: torch.Tensor,  # (..., 2) float32
    depth: float,
    time: torch.Tensor,      # (...) float32
    g: float = spectra.G,
    omega: torch.Tensor | None = None,   # (..., rows, N) float32
    y_offset: int = 0,
) -> torch.Tensor:
    """The 4 packed layers as fp32 plane pairs, (..., 4, 2, rows, N).

    Leading dimensions are a cascade batch. The block holds texel rows
    y_offset .. y_offset + rows - 1 of the N x N grid (a row shard; all of it
    by default). `omega` is the host-exact dispersion plane
    (spectra.dispersion_grid_host); None recomputes it.
    Closed real forms of the packed layers (glsl:71-89):

      L0 = (1 + ku_y) * (i h)            L2 = (k_x - k_y ku_y) * (i h)
      L1 = i h ku_x - h k_y              L3 = -ku_x * (h * (k_x + i k_y))
    """
    rows, n = h0.shape[-2], h0.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=h0.device) - n * 0.5
    idy = torch.arange(rows, dtype=torch.float32, device=h0.device) + y_offset - n * 0.5
    kx = idx[None, :] * grid.scalar_div(grid.TWO_PI, tile_length[..., 0, None, None])
    ky = idy[:, None] * grid.scalar_div(grid.TWO_PI, tile_length[..., 1, None, None])
    kx, ky = torch.broadcast_tensors(kx, ky)
    k = torch.sqrt(kx * kx + ky * ky) + 1e-6
    kux = kx / k
    kuy = ky / k

    w = spectra.deep_dispersion(k, depth, g) if omega is None else omega
    phase = w * time[..., None, None]
    c = torch.cos(phase)
    s = torch.sin(phase)
    h0r, h0i = h0[..., 0, :, :], h0[..., 1, :, :]
    ncr, nci = h0nc[..., 0, :, :], h0nc[..., 1, :, :]
    # h = h0 e^{i w t} + conj(h0(-k)) e^{-i w t}  (glsl:62-68)
    hr = c * (h0r + ncr) + s * (nci - h0i)
    hi = s * (h0r - ncr) + c * (h0i + nci)

    a0 = 1.0 + kuy
    l0 = (-hi * a0, hr * a0)
    l1 = (-hi * kux - hr * ky, hr * kux - hi * ky)
    a2 = kx - ky * kuy
    l2 = (-hi * a2, hr * a2)
    l3 = (kux * (hi * ky - hr * kx), -kux * (hr * ky + hi * kx))
    return torch.stack([torch.stack(l, dim=-3) for l in (l0, l1, l2, l3)], dim=-4)
