"""Spectrum energy statistics of the port vs analytic integrals, and its
map-dtype error budgets, on the CPU. The twin of
tests/test_energy_statistics.py (its cases, seeds, sizes and bounds; the
derivation of E[Var(h)] = 8 * sum_k S D (dw/dk)/k dkx dky is there).

The analytic side is the oracle's fp64 quadrature, independent of both
packages. Beside each statistic, the port is held to the JAX package on the
same inputs: the initial spectrum and the fp32 maps within 1e-4 relative
RMS (as tests/test_torch_slice.py), and its own spectral density (the
port's `ops/spectra.py` in fp32) within 1e-5 relative of the oracle's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.ops import initial_state as jinit

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.ops import initial_state, spectra

import oracle

N = 128
DEPTH = 20.0
WIND = 20.0
FETCH = 550.0   # km, cascade-0 scene default scale
TILE = 88.0


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return float(np.sqrt(np.mean(np.abs(got - ref) ** 2) / max(1e-300, np.mean(np.abs(ref) ** 2))))


def _alpha_wp():
    return (oracle.jonswap_alpha(WIND, FETCH * 1e3),
            oracle.jonswap_peak_angular_frequency(WIND, FETCH * 1e3))


def _spectral_density(kx, ky):
    """S(w(k)) * D(theta) * (dw/dk)/k on fp64 k-grids (oracle math); spread 0
    => pure Hasselmann, detail 1 => no suppression."""
    alpha, w_p = _alpha_wp()
    k = np.sqrt(kx * kx + ky * ky) + 1e-6
    theta = np.arctan2(kx, ky)
    w, dw = oracle.dispersion_relation(k.astype(np.float32), DEPTH)
    s = oracle.tma_spectrum(w, np.float32(w_p), np.float32(alpha), DEPTH)
    d = oracle.hasselmann_directional_spread(
        w, np.float32(w_p), np.float32(WIND), theta.astype(np.float32),
        np.float32(0.0), np.float32(0.0))
    return s.astype(np.float64) * d.astype(np.float64) * (dw.astype(np.float64) / k)


def _port_spectral_density(kx, ky):
    """The same density from the port's `ops/spectra.py` (fp32), in fp64."""
    alpha, w_p = _alpha_wp()
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    k = np.sqrt(kx * kx + ky * ky) + 1e-6
    theta = np.arctan2(kx, ky)
    w, dw = spectra.dispersion_relation(f32(k), DEPTH)
    s = spectra.tma_spectrum(w, f32(w_p), f32(alpha), DEPTH)
    d = spectra.hasselmann_directional_spread(w, f32(w_p), f32(WIND), f32(theta), f32(0.0),
                                              f32(0.0))
    return s.double().numpy() * d.double().numpy() * (dw.double().numpy() / k)


def _grid_sum(n, tile, density=_spectral_density):
    """sum_k S*D*(dw/dk)/k * dkx*dky over the n x n centered k-grid."""
    dk = 2.0 * np.pi / tile
    ids = np.arange(n, dtype=np.float64) - n / 2.0
    return float(np.sum(density(ids[None, :] * dk, ids[:, None] * dk)) * dk * dk)


def _cascade(seed, tile=TILE):
    """One cascade of the wind sea, as port params (CPU) and JAX params."""
    kw = dict(tile_length=tile, wind_speed=WIND, fetch_length=FETCH, swell=0.0, detail=1.0,
              spread=0.0, spectrum_seed=seed)
    return (T.CascadeParams.create(device="cpu", **kw).map(lambda x: x[None]),
            jax.tree.map(lambda x: x[None], J.CascadeParams.create(**kw)))


def test_rng_complex_gaussian_unit_variance():
    """E|h0|^2 / envelope^2 == 2 texel-wise (complex Gaussian, both parts
    N(0,1)), and E|g|^4 == 8, for the port's h0 at 256^2; the port's h0
    equals the JAX package's from the same arguments."""
    n = 256
    alpha, w_p = _alpha_wp()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    args = (n, torch.tensor([3, 11], dtype=torch.int32), f32([TILE, TILE]), f32(alpha),
            f32(w_p), f32(WIND), f32(0.0), DEPTH, f32(0.0), f32(1.0), f32(0.0))
    amp, _ = initial_state.build_initial_spectrum(*args)
    amp = amp.numpy()
    jargs = (n, jnp.array([3, 11], jnp.int32), jnp.array([TILE, TILE], jnp.float32),
             jnp.float32(alpha), jnp.float32(w_p), jnp.float32(WIND), jnp.float32(0.0), DEPTH,
             jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0))
    assert rel_rms(amp, np.asarray(jinit.build_initial_spectrum(*jargs)[0])) <= 1e-4

    dk = 2.0 * np.pi / TILE
    ids = np.arange(n, dtype=np.float64) - n / 2.0
    env2 = 2.0 * _spectral_density(ids[None, :] * dk, ids[:, None] * dk) * dk * dk
    with np.errstate(divide="ignore", invalid="ignore"):
        g2 = np.abs(amp.astype(np.complex128)) ** 2 / env2
    # drop texels where the envelope underflows fp32 (k far past the peak)
    g2 = g2[env2 > 1e-30]
    assert abs(g2.mean() - 2.0) < 0.05, g2.mean()
    assert abs((g2 ** 2).mean() - 8.0) < 0.6, (g2 ** 2).mean()


def test_height_variance_matches_spectral_expectation():
    """Ensemble-averaged map variance == 8 * discrete spectral sum, over 12
    seeds at a 1024 m tile (the JONSWAP peak ring spans many modes); the
    first seed's maps equal the JAX package's."""
    tile = 1024.0
    cfg, jcfg = T.SimConfig(map_size=N), J.SimConfig(map_size=N)
    expect = 8.0 * _grid_sum(N, tile)

    variances = []
    for i, seed in enumerate([(3, 11), (101, 7), (55, 90), (1234, 4321), (9, 999),
                              (77, 13), (2024, 1), (500, 500), (18, 2), (64, 640),
                              (7, 70), (123, 321)]):
        params, jp = _cascade(seed, tile)
        _, maps = T.step(cfg, T.init_state(cfg, params), params, 0.02)
        if i == 0:
            _, jm = J.step(jcfg, J.init_state(jcfg, jp), jp, 0.02)
            assert rel_rms(maps.displacement.numpy(), jm.displacement) <= 1e-4
        variances.append(float(maps.displacement[0, 1].double().var(unbiased=False)))

    mean_var = float(np.mean(variances))
    assert abs(mean_var - expect) / expect < 0.15, (mean_var, expect)
    # every single realization should be the right order of magnitude
    assert all(0.3 * expect < v < 3.0 * expect for v in variances), variances


def test_spectral_sum_converges_to_continuous_integral():
    """The map-grid spectral sum of the port's density is a converged
    quadrature of the continuous integral over the same k-square: refining
    dk 4x moves it by < 2 %, 8x by < 0.2 % more; at the 88 m demo tile the
    peak falls inside the first grid cell and is truncated."""
    tile = 1024.0
    dk = 2.0 * np.pi / tile
    ids = np.arange(N, dtype=np.float64) - N / 2.0
    kx, ky = ids[None, :] * dk, ids[:, None] * dk
    port, ref = _port_spectral_density(kx, ky), _spectral_density(kx, ky)
    assert np.sqrt(np.mean((port - ref) ** 2) / np.mean(ref ** 2)) <= 1e-5

    grid = lambda n, t: _grid_sum(n, t, _port_spectral_density)
    coarse, fine, finer = grid(N, tile), grid(4 * N, 4.0 * tile), grid(8 * N, 8.0 * tile)
    assert abs(coarse - fine) / fine < 0.02, (coarse, fine)
    assert abs(fine - finer) / finer < 0.002, (fine, finer)
    assert grid(N, TILE) < 0.6 * grid(4 * N, 4.0 * TILE)


@pytest.mark.parametrize("n", [64, 128, 256])
def test_map_dtype_error_budget_across_sizes(n):
    """bf16/fp16 maps hold their quantization budgets at every size (no
    accumulation after the final cast); fp16's 11-bit mantissa beats bf16's
    8-bit; the fp32 maps equal the JAX package's."""
    params, jp = _cascade((42, 43))
    budgets = {"bfloat16": 8e-3, "float16": 1e-3}  # ~2-3x measured RMS
    cfg32 = T.SimConfig(map_size=n)
    _, maps32 = T.step(cfg32, T.init_state(cfg32, params), params, 0.02)
    d32 = maps32.displacement.double().numpy()
    jcfg = J.SimConfig(map_size=n)
    _, jm = J.step(jcfg, J.init_state(jcfg, jp), jp, 0.02)
    assert rel_rms(d32, jm.displacement) <= 1e-4
    scale = np.sqrt(np.mean(d32 ** 2))

    errs = {}
    for dtype, budget in budgets.items():
        cfg = T.SimConfig(map_size=n, map_dtype=dtype)
        _, maps = T.step(cfg, T.init_state(cfg, params), params, 0.02)
        d = maps.displacement.double().numpy()
        errs[dtype] = np.sqrt(np.mean((d - d32) ** 2)) / scale
        assert errs[dtype] < budget, (dtype, n, errs[dtype])
    assert errs["float16"] < errs["bfloat16"], errs
