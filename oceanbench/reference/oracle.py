"""NumPy oracle: an independent transcription of the reference GLSL kernels.

A frozen copy of the repository's `tests/oracle.py`, kept beside the
benchmark so that later changes to the tests cannot move the yardstick.
Two departures, both marked where they sit: `gaussian` floors u0 at the
smallest normal fp32 (the hash emits u0 == 0 with p = 2^-31 a texel, where
log(0) would put an infinite amplitude into a cascade; the program floors
it the same way), and `packed_spectrum` indexes -k with a flip and a roll
instead of a Python loop (the loop is kept as `packed_spectrum_loop`, and
the benchmark's tests hold the two equal).

The reference repo has no tests and its GPU is unavailable, so the oracle IS
the shader math, re-executed in NumPy float32/uint32 (SURVEY.md section 4).
Every function cites the GLSL it transcribes. This module deliberately avoids
the library under test (no jax imports) and favors literal, staged execution —
including a per-stage emulation of the Stockham butterfly kernel — over clever
vectorized identities, so it can falsify the library's algebraic shortcuts.
"""
from __future__ import annotations

import numpy as np

G = np.float32(9.81)
PI = 3.141592653589793


# --- rng: spectrum_compute.glsl:34-49 ---

def hash_uvec2(x, y):
    x = np.asarray(x).astype(np.int64).astype(np.uint32)
    y = np.asarray(y).astype(np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        h32 = y + np.uint32(374761393) + x * np.uint32(3266489917)
        h32 = np.uint32(2246822519) * (h32 ^ (h32 >> np.uint32(15)))
        h32 = np.uint32(3266489917) * (h32 ^ (h32 >> np.uint32(13)))
        n = h32 ^ (h32 >> np.uint32(16))
        rz0 = n
        rz1 = n * np.uint32(48271)
    denom = np.float32(0x7FFFFFFF)  # rounds to 2^31 in fp32, as in GLSL
    u0 = ((rz0 >> np.uint32(1)) & np.uint32(0x7FFFFFFF)).astype(np.float32) / denom
    u1 = ((rz1 >> np.uint32(1)) & np.uint32(0x7FFFFFFF)).astype(np.float32) / denom
    return u0, u1


def gaussian(u0, u1):
    # departure: u0 floored at the smallest normal fp32 (see the module note)
    u0 = np.maximum(u0.astype(np.float32), np.float32(1.1754944e-38))
    r = np.sqrt(np.float32(-2.0) * np.log(u0))
    theta = np.float32(2.0 * PI) * u1.astype(np.float32)
    return (r * np.cos(theta) + 1j * (r * np.sin(theta))).astype(np.complex64)


# --- spectra: spectrum_compute.glsl:58-101 ---

def dispersion_relation(k, depth):
    k = np.asarray(k, np.float32)
    a = k * np.float32(depth)
    b = np.tanh(a)
    w = np.sqrt(G * k * b)
    dw = np.float32(0.5) * G * (b + a * (np.float32(1.0) - b * b)) / w
    return w, dw


def longuet_higgins_normalization(s):
    s = np.asarray(s, np.float32)
    a = np.sqrt(s)
    small = np.float32(0.5 / PI) + s * (np.float32(0.220636) + s * (np.float32(-0.109) + s * np.float32(0.090)))
    with np.errstate(divide="ignore"):
        large = np.float32(1.0 / np.sqrt(PI)) * (a * np.float32(0.5) + (np.float32(1.0) / a) * np.float32(0.0625))
    return np.where(s < np.float32(0.4), small, large).astype(np.float32)


def longuet_higgins_function(s, theta):
    return longuet_higgins_normalization(s) * np.power(
        np.abs(np.cos(np.asarray(theta, np.float32) * np.float32(0.5))), np.float32(2.0) * s
    ).astype(np.float32)


def hasselmann_directional_spread(w, w_p, wind_speed, theta, swell, angle):
    w = np.asarray(w, np.float32)
    p = w / np.float32(w_p)
    s_below = np.float32(6.97) * np.power(np.abs(p), np.float32(4.06))
    expo = np.float32(-2.33) - np.float32(1.45) * (np.float32(wind_speed) * np.float32(w_p) / G - np.float32(1.17))
    s_above = np.float32(9.77) * np.power(np.abs(p), expo)
    s = np.where(w <= np.float32(w_p), s_below, s_above).astype(np.float32)
    s_xi = np.float32(16.0) * np.tanh(np.float32(w_p) / w) * np.float32(swell) ** 2
    return longuet_higgins_function(s + s_xi, np.asarray(theta, np.float32) - np.float32(angle))


def tma_spectrum(w, w_p, alpha, depth):
    w = np.asarray(w, np.float32)
    w_p = np.float32(w_p)
    sigma = np.where(w <= w_p, np.float32(0.07), np.float32(0.09))
    r = np.exp(-(w - w_p) * (w - w_p) / (np.float32(2.0) * sigma * sigma * w_p * w_p))
    with np.errstate(over="ignore"):
        jonswap = (np.float32(alpha) * G * G) / np.power(w, np.float32(5)) \
            * np.exp(np.float32(-1.25) * np.power(w_p / w, np.float32(4))) \
            * np.power(np.float32(3.3), r)
    w_h = np.minimum(w * np.sqrt(np.float32(depth) / G), np.float32(2.0))
    atten = np.where(
        w_h <= np.float32(1.0),
        np.float32(0.5) * w_h * w_h,
        np.float32(1.0) - np.float32(0.5) * (np.float32(2.0) - w_h) * (np.float32(2.0) - w_h),
    )
    return (jonswap * atten).astype(np.float32)


def jonswap_alpha(wind_speed, fetch_length_m):
    # wave_generator.gd:116-117
    return np.float32(0.076) * np.power(np.float32(wind_speed) ** 2 / (np.float32(fetch_length_m) * G), np.float32(0.22))


def jonswap_peak_angular_frequency(wind_speed, fetch_length_m):
    # wave_generator.gd:120-121
    return np.float32(22.0) * np.power(G * G / (np.float32(wind_speed) * np.float32(fetch_length_m)), np.float32(1.0 / 3.0))


# --- initial spectrum: spectrum_compute.glsl:103-124 ---

def spectrum_amplitude(n, seed, tile_length, alpha, w_p, wind_speed, angle,
                       depth, swell, detail, spread):
    """h0 amplitude grid (n, n) complex64, indexed [y, x]."""
    ids = np.arange(n, dtype=np.float32)
    idx = np.broadcast_to(ids[None, :], (n, n))   # id.x along last axis
    idy = np.broadcast_to(ids[:, None], (n, n))
    dkx = np.float32(2.0 * PI) / np.float32(tile_length[0])
    dky = np.float32(2.0 * PI) / np.float32(tile_length[1])
    kx = (idx - np.float32(n) * np.float32(0.5)) * dkx
    ky = (idy - np.float32(n) * np.float32(0.5)) * dky
    k = np.sqrt(kx * kx + ky * ky) + np.float32(1e-6)
    theta = np.arctan2(kx, ky)  # GLSL atan(k.x, k.y)

    w, dw = dispersion_relation(k, depth)
    w_norm = dw / k * (dkx * dky)
    s = tma_spectrum(w, w_p, alpha, depth)
    d_hass = hasselmann_directional_spread(w, w_p, wind_speed, theta, swell, angle)
    t = np.float32(1.0) - np.float32(spread)
    d = (np.float32(0.5 / PI) * (np.float32(1.0) - t) + d_hass * t) * np.exp(
        -(np.float32(1.0) - np.float32(detail)) ** 2 * k * k
    )
    ix = np.broadcast_to(np.arange(n, dtype=np.int64)[None, :], (n, n))
    iy = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, n))
    u0, u1 = hash_uvec2(ix + int(seed[0]), iy + int(seed[1]))
    return gaussian(u0, u1) * np.sqrt(np.float32(2.0) * s * d * w_norm)


def packed_spectrum(n, seed, tile_length, alpha, w_p, wind_speed, angle,
                    depth, swell, detail, spread):
    """(h0(k), conj(h0(-k))) (glsl:118-124); -k as a flip and a roll of one
    texel on both axes (departure: see the module note)."""
    amp = spectrum_amplitude(n, seed, tile_length, alpha, w_p, wind_speed,
                             angle, depth, swell, detail, spread)
    h0nc = np.conj(np.roll(amp[::-1, ::-1], 1, axis=(0, 1)))
    return amp, h0nc.astype(np.complex64)


def packed_spectrum_loop(n, seed, tile_length, alpha, w_p, wind_speed, angle,
                         depth, swell, detail, spread):
    """(h0(k), conj(h0(-k))) via literal per-texel -k indexing (glsl:118-124)."""
    amp = spectrum_amplitude(n, seed, tile_length, alpha, w_p, wind_speed,
                             angle, depth, swell, detail, spread)
    h0nc = np.empty_like(amp)
    for y in range(n):
        for x in range(n):
            h0nc[y, x] = np.conj(amp[(-y) % n, (-x) % n])
    return amp, h0nc


# --- modulation + packing: spectrum_modulate.glsl:53-89 ---

def modulate(h0, h0nc, tile_length, depth, time):
    n = h0.shape[-1]
    ids = np.arange(n, dtype=np.float32)
    idx = np.broadcast_to(ids[None, :], (n, n))
    idy = np.broadcast_to(ids[:, None], (n, n))
    kx = (idx - np.float32(n) * np.float32(0.5)) * np.float32(2.0 * PI) / np.float32(tile_length[0])
    ky = (idy - np.float32(n) * np.float32(0.5)) * np.float32(2.0 * PI) / np.float32(tile_length[1])
    k = np.sqrt(kx * kx + ky * ky) + np.float32(1e-6)
    kux, kuy = kx / k, ky / k

    disp = np.sqrt(G * k * np.tanh(k * np.float32(depth))) * np.float32(time)
    modv = np.cos(disp) + 1j * np.sin(disp)
    h = h0 * modv.astype(np.complex64) + h0nc * np.conj(modv).astype(np.complex64)
    ih = 1j * h

    hx = ih * kuy
    hy = h
    hz = ih * kux
    dhy_dx = ih * ky
    dhy_dz = ih * kx
    dhx_dx = -h * ky * kuy
    dhz_dz = -h * kx * kux
    dhz_dx = -h * ky * kux

    l0 = hx + 1j * hy
    l1 = hz + 1j * dhy_dx
    l2 = dhy_dz + 1j * dhx_dx
    l3 = dhz_dz + 1j * dhz_dx
    return np.stack([l0, l1, l2, l3]).astype(np.complex64)


# --- Stockham FFT chain: fft_butterfly.glsl + fft_compute.glsl + transpose.glsl ---

def butterfly_factors(n):
    """(num_stages, n) arrays of (r0, r1, twiddle) per fft_butterfly.glsl:24-34."""
    num_stages = int(np.log2(n))
    r0 = np.zeros((num_stages, n), np.int64)
    r1 = np.zeros((num_stages, n), np.int64)
    tw = np.zeros((num_stages, n), np.complex64)
    for stage in range(num_stages):
        for col in range(n // 2):
            stride = 1 << stage
            mid = n >> (stage + 1)
            i, j = col >> stage, col % stride
            t = np.complex64(np.cos(np.float32(PI / stride * j)) + 1j * np.sin(np.float32(PI / stride * j)))
            w0 = stride * (2 * i + 0) + j
            w1 = stride * (2 * i + 1) + j
            r0[stage, w0] = r0[stage, w1] = stride * i + j
            r1[stage, w0] = r1[stage, w1] = stride * (i + mid) + j
            tw[stage, w0] = t
            tw[stage, w1] = -t
    return r0, r1, tw


def stockham_rows(x, factors):
    """Row-wise staged Stockham execution per fft_compute.glsl:45-58."""
    r0, r1, tw = factors
    num_stages = r0.shape[0]
    out = np.array(x, np.complex64)
    for stage in range(num_stages):
        out = out[..., r0[stage]] + out[..., r1[stage]] * tw[stage]
    return out


def reference_fft_chain(layers, factors):
    """rows -> transpose -> rows, NO second transpose (wave_generator.gd:77-82)."""
    y = stockham_rows(layers, factors)
    y = np.swapaxes(y, -2, -1)  # transpose.glsl
    return stockham_rows(y, factors)


# --- unpack: fft_unpack.glsl ---

def unpack(layers, foam_prev, whitecap, grow, decay):
    n = layers.shape[-1]
    ix = np.broadcast_to(np.arange(n)[None, :], (n, n))
    iy = np.broadcast_to(np.arange(n)[:, None], (n, n))
    sign = np.where((ix + iy) % 2 == 0, np.float32(1.0), np.float32(-1.0))

    hx = layers[0].real * sign
    hy = layers[0].imag * sign
    hz = layers[1].real * sign
    dhy_dx = layers[1].imag * sign
    dhy_dz = layers[2].real * sign
    dhx_dx = layers[2].imag * sign
    dhz_dz = layers[3].real * sign
    dhz_dx = layers[3].imag * sign

    displacement = np.stack([hx, hy, hz], -1)
    jac = (np.float32(1.0) + dhx_dx) * (np.float32(1.0) + dhz_dz) - dhz_dx * dhz_dx
    foam_factor = -np.minimum(np.float32(0.0), jac - np.float32(whitecap))
    foam = foam_prev * np.exp(np.float32(-decay)) + foam_factor * np.float32(grow)
    foam = np.clip(foam, 0.0, 1.0).astype(np.float32)
    grad = np.stack([dhy_dx, dhy_dz], -1) / (np.float32(1.0) + np.abs(np.stack([dhx_dx, dhz_dz], -1)))
    normal = np.concatenate([grad, dhx_dx[..., None], foam[..., None]], -1)
    return displacement.astype(np.float32), normal.astype(np.float32), foam
