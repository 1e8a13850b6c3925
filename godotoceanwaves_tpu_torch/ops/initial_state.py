"""Initial spectral state h0(k) generation (PyTorch port of `ops/initial_state.py`).

amplitude = gaussian(hash(id + seed)) * sqrt(2 S(w) D(theta) (dw/dk)/k dkx dky)
(spectrum_compute.glsl:103-124). Runs only when a spectrum-affecting
parameter changes (dirty bit, wave_generator.gd:67-72), so it stays plain
PyTorch on whichever device the parameters live on.
"""
from __future__ import annotations

import torch

from . import grid, rng, spectra


def spectrum_amplitude_at(
    ix: torch.Tensor,        # integer texel x indices (any shape)
    iy: torch.Tensor,        # integer texel y indices (same shape)
    map_size: int,
    seed: torch.Tensor,      # (2,) int32
    tile_length: torch.Tensor,  # (2,) float32 (Lx, Ly)
    alpha,
    peak_frequency,
    wind_speed,
    angle,                   # wind direction, radians
    depth: float,
    swell,
    detail,
    spread,
    g: float = spectra.G,
) -> torch.Tensor:
    """h0 amplitude at explicit texel indices, complex64
    (get_spectrum_amplitude, spectrum_compute.glsl:103-114)."""
    n = map_size
    dkx = grid.scalar_div(grid.TWO_PI, tile_length[0])
    dky = grid.scalar_div(grid.TWO_PI, tile_length[1])
    kx = (ix.to(torch.float32) - n * 0.5) * dkx
    ky = (iy.to(torch.float32) - n * 0.5) * dky
    k = torch.sqrt(kx * kx + ky * ky) + 1e-6
    # GLSL atan(k_vec.x, k_vec.y) == atan2(y=k_vec.x, x=k_vec.y)  (glsl:106)
    theta = torch.atan2(kx, ky)

    w, dw_dk = spectra.dispersion_relation(k, depth, g)
    w_norm = dw_dk / k * (dkx * dky)

    s = spectra.tma_spectrum(w, peak_frequency, alpha, depth, g)
    hass = spectra.hasselmann_directional_spread(
        w, peak_frequency, wind_speed, theta, swell, angle, g)
    # mix(1/(2*pi), hasselmann, 1 - spread)  (glsl:113)
    t = 1.0 - spread
    d = ((0.5 / spectra.PI) * (1.0 - t) + hass * t) * torch.exp(
        -(1.0 - detail) * (1.0 - detail) * k * k)

    u0, u1 = rng.hash_uvec2(ix + seed[0].to(torch.int64), iy + seed[1].to(torch.int64))
    gauss = rng.gaussian_pair(u0, u1)
    return gauss * torch.sqrt(2.0 * s * d * w_norm)


def build_initial_spectrum(
    map_size: int,
    seed,
    tile_length,
    alpha,
    peak_frequency,
    wind_speed,
    angle,
    depth: float,
    swell,
    detail,
    spread,
    g: float = spectra.G,
    y_offset: int = 0,
    rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed initial state (h0(k), conj(h0(-k))), each complex64 (rows, N):
    texel rows y_offset .. y_offset + rows - 1 of the N x N grid (all of it
    by default).

    The -k companion is evaluated directly at `mod(-id, N)` of the global
    texel indices (spectrum_compute.glsl:118-124), bit-identical to a
    flip/roll, so a row-sharded block needs no other rows.
    """
    n = map_size
    r = n if rows is None else rows
    dev = tile_length.device
    ix = torch.arange(n, dtype=torch.int64, device=dev)[None, :].expand(r, n)
    iy = (torch.arange(r, dtype=torch.int64, device=dev) + y_offset)[:, None].expand(r, n)
    args = (map_size, seed, tile_length, alpha, peak_frequency, wind_speed,
            angle, depth, swell, detail, spread, g)
    h0 = spectrum_amplitude_at(ix, iy, *args)
    # mod(-id, N) per component (GLSL floor-mod => non-negative result)
    h0_neg_conj = torch.conj(spectrum_amplitude_at((-ix) % n, (-iy) % n, *args))
    return h0, h0_neg_conj.resolve_conj()
