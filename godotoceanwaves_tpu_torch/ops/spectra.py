"""Closed-form ocean-wave spectrum math (PyTorch port of `ops/spectra.py`).

  - finite-depth dispersion relation and its k-derivative
    (spectrum_compute.glsl:58-66)
  - Longuet-Higgins directional normalization and function (glsl:69-78)
  - Hasselmann directional spread with swell shaping (glsl:81-86)
  - TMA spectrum = JONSWAP x Kitaigorodskii depth attenuation (glsl:89-101)
  - JONSWAP alpha / peak angular frequency (wave_generator.gd:115-121)

All math is float32 to mirror the shader. `dispersion_grid_host` stays NumPy:
the stored omega plane must be bit-identical to the parity oracle's.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import scalar_div

G = 9.81
PI = 3.141592653589793
# fp32 1/sqrt(pi) rounded as jnp.float32(1.0 / jnp.sqrt(PI)) rounds it
_INV_SQRT_PI = float(np.float32(1.0) / np.sqrt(np.float32(PI)))


def dispersion_relation(k: torch.Tensor, depth: float, g: float = G
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Finite-depth w(k) = sqrt(g k tanh(k depth)) and dw/dk (glsl:58-66)."""
    a = k * depth
    b = torch.tanh(a)
    w = torch.sqrt(g * k * b)
    dw_dk = (0.5 * g) * (b + a * (1.0 - b * b)) / w
    return w, dw_dk


def deep_dispersion(k: torch.Tensor, depth: float, g: float = G) -> torch.Tensor:
    """sqrt(g k tanh(k depth)) as the modulation stage uses it
    (spectrum_modulate.glsl:49-51)."""
    return torch.sqrt(g * k * torch.tanh(k * depth))


def dispersion_grid_host(n: int, tile_length, depth: float, g: float = G,
                         rows: int | None = None, y_offset: int = 0) -> np.ndarray:
    """omega(k) over the centered texel k-grid, computed on the host in NumPy
    fp32 with the exact op order of the oracle's dispersion (tests/oracle.py
    modulate): np.ndarray (rows or n, n).

    The per-frame phase omega*t (t ~ 120 s, water.gd:31) amplifies any omega
    error, so omega is initial state, computed once next to h0.
    """
    rows = n if rows is None else rows
    f32 = np.float32
    ids_x = np.arange(n, dtype=f32)
    ids_y = np.arange(y_offset, y_offset + rows, dtype=f32)
    idx = np.broadcast_to(ids_x[None, :], (rows, n))
    idy = np.broadcast_to(ids_y[:, None], (rows, n))
    lx, ly = (f32(v) for v in np.asarray(tile_length, f32))
    kx = (idx - f32(n) * f32(0.5)) * f32(2.0 * PI) / lx
    ky = (idy - f32(n) * f32(0.5)) * f32(2.0 * PI) / ly
    k = np.sqrt(kx * kx + ky * ky) + f32(1e-6)
    return np.sqrt(f32(g) * k * np.tanh(k * f32(depth)))


def longuet_higgins_normalization(s: torch.Tensor) -> torch.Tensor:
    """Normalization approximation for the Longuet-Higgins function (glsl:69-73)."""
    a = torch.sqrt(s)
    small = (0.5 / PI) + s * (0.220636 + s * (-0.109 + s * 0.090))
    large = _INV_SQRT_PI * (a * 0.5 + torch.reciprocal(a) * 0.0625)
    return torch.where(s < 0.4, small, large)


def longuet_higgins_function(s: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """D(theta) = Q(s) * |cos(theta/2)|^(2s)  (glsl:76-78)."""
    return longuet_higgins_normalization(s) * torch.pow(
        torch.abs(torch.cos(theta * 0.5)), 2.0 * s)


def hasselmann_directional_spread(w, w_p, wind_speed, theta, swell, angle,
                                  g: float = G) -> torch.Tensor:
    """Hasselmann frequency-dependent spread + Horvath swell shaping
    (glsl:81-86). `angle` is the wind direction in radians."""
    p = w / w_p
    s_below = 6.97 * torch.pow(torch.abs(p), 4.06)
    exponent = -2.33 - 1.45 * (wind_speed * w_p / g - 1.17)
    s_above = 9.77 * torch.pow(torch.abs(p), exponent)
    s = torch.where(w <= w_p, s_below, s_above)
    s_xi = 16.0 * torch.tanh(w_p / w) * swell * swell
    return longuet_higgins_function(s + s_xi, theta - angle)


def tma_spectrum(w, w_p, alpha, depth: float, g: float = G) -> torch.Tensor:
    """TMA spectrum: JONSWAP (gamma = 3.3) x Kitaigorodskii depth attenuation
    (glsl:89-101, w_h clamped to <= 2)."""
    sigma = torch.where(w <= w_p, 0.07, 0.09).to(torch.float32)
    r = torch.exp(-(w - w_p) * (w - w_p) / (2.0 * sigma * sigma * w_p * w_p))
    gamma = torch.tensor(3.3, dtype=torch.float32, device=w.device)
    jonswap = ((alpha * (g * g)) / torch.pow(w, 5)
               * torch.exp(-1.25 * torch.pow(w_p / w, 4))
               * torch.pow(gamma, r))
    w_h = torch.clamp_max(w * float(np.sqrt(np.float32(depth / g))), 2.0)
    attenuation = torch.where(
        w_h <= 1.0,
        0.5 * w_h * w_h,
        1.0 - 0.5 * (2.0 - w_h) * (2.0 - w_h),
    )
    return jonswap * attenuation


def jonswap_alpha(wind_speed: torch.Tensor, fetch_length_m: torch.Tensor,
                  g: float = G) -> torch.Tensor:
    """JONSWAP alpha = 0.076 * (U^2 / (F g))^0.22  (wave_generator.gd:116-117)."""
    return 0.076 * torch.pow(wind_speed * wind_speed / (fetch_length_m * g), 0.22)


def jonswap_peak_angular_frequency(wind_speed: torch.Tensor,
                                   fetch_length_m: torch.Tensor,
                                   g: float = G) -> torch.Tensor:
    """omega_p = 22 * (g^2 / (U F))^(1/3)  (wave_generator.gd:120-121)."""
    return 22.0 * torch.pow(scalar_div(g * g, wind_speed * fetch_length_m), 1.0 / 3.0)
