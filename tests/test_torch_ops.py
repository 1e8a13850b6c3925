"""PyTorch port ops vs the JAX package and the NumPy oracle (CPU).

Inputs are made with NumPy from a seed and handed to both packages as
arrays. Tolerances are stated per test: the hash and the host-side NumPy
copies are bit-exact; fp32 transcendental chains agree to ~1e-6 relative.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from godotoceanwaves_tpu import default_cascades as jax_default_cascades
from godotoceanwaves_tpu.models.cascade import CascadeParams as JaxParams
from godotoceanwaves_tpu.ops import (fft as jfft, grid as jgrid, modulate as jmod,
                                     rng as jrng, spectra as jspectra,
                                     unpack as junpack)
from godotoceanwaves_tpu.utils import godot_rng as jgodot

from godotoceanwaves_tpu_torch import default_cascades
from godotoceanwaves_tpu_torch.models.cascade import CascadeParams, SimConfig
from godotoceanwaves_tpu_torch.ops import fft, grid, modulate, rng, spectra, unpack
from godotoceanwaves_tpu_torch.utils import godot_rng

# texel + seed words at the edges of the uint32 reinterpretation
EDGE_SEEDS = {
    "negative": (-1, -12345),
    "plus_minus_10000": (10000, -10000),
    "wraparound": (2**31 - 7, -(2**31) + 3),
}


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _texels(seed_pair, n=64):
    ix, iy = np.meshgrid(np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64))
    return ix + seed_pair[0], iy + seed_pair[1]


@pytest.mark.parametrize("seeds", list(EDGE_SEEDS.values()), ids=list(EDGE_SEEDS))
def test_hash_uvec2_bit_exact(seeds):
    x, y = _texels(seeds)
    got = rng.hash_uvec2(_t(x), _t(y))
    want_oracle = oracle.hash_uvec2(x, y)
    # JAX wraps the int32 sum the same way GLSL's uvec2(id + seed) does
    xw, yw = (((v + 2**31) % 2**32) - 2**31 for v in (x, y))
    want_jax = jrng.hash_uvec2(jnp.asarray(xw, jnp.int32), jnp.asarray(yw, jnp.int32))
    for g, o, j in zip(got, want_oracle, want_jax):
        np.testing.assert_array_equal(g.numpy(), o)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("seeds", list(EDGE_SEEDS.values()), ids=list(EDGE_SEEDS))
def test_hash32_uvec2_bit_exact(seeds):
    x, y = _texels(seeds)
    xw, yw = (((v + 2**31) % 2**32) - 2**31 for v in (x, y))
    got = rng.hash32_uvec2(_t(x), _t(y))
    want = jrng.hash32_uvec2(jnp.asarray(xw, jnp.int32), jnp.asarray(yw, jnp.int32))
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_gaussian_pair_matches_jax():
    """Box-Muller of the same uniforms, incl. the u0 == 0 floor: <= 1e-6."""
    r = np.random.default_rng(3)
    u0 = r.uniform(0, 1, 4096).astype(np.float32)
    u1 = r.uniform(0, 1, 4096).astype(np.float32)
    u0[:2] = 0.0
    got = rng.gaussian_pair(_t(u0), _t(u1)).numpy()
    want = np.asarray(jrng.gaussian_pair(jnp.asarray(u0), jnp.asarray(u1)))
    assert np.isfinite(got).all()
    assert rel_rms(got.real, want.real) < 1e-6 and rel_rms(got.imag, want.imag) < 1e-6


@pytest.mark.parametrize("n,tile", [(64, (88.0, 88.0)), (128, (57.0, 31.0))])
def test_dispersion_grid_host_bit_equal(n, tile):
    np.testing.assert_array_equal(spectra.dispersion_grid_host(n, tile, 20.0),
                                  jspectra.dispersion_grid_host(n, tile, 20.0))


@pytest.mark.parametrize("seed", [1234, 0, 99])
def test_godot_rng_bit_equal(seed):
    a, b = godot_rng.GodotRNG(seed), jgodot.GodotRNG(seed)
    assert [a.randi_range(-10000, 10000) for _ in range(64)] == \
        [b.randi_range(-10000, 10000) for _ in range(64)]
    assert [a.randi() for _ in range(16)] == [b.randi() for _ in range(16)]


@pytest.mark.parametrize("godot_seeds", [False, True])
def test_default_cascades_equal_jax(godot_seeds):
    got = default_cascades(godot_seeds=godot_seeds, device="cpu")
    want = jax_default_cascades(godot_seeds=godot_seeds)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def test_cascade_params_create_clamps_like_jax():
    kw = dict(tile_length=31.0, wind_speed=0.0, fetch_length=-5.0, spectrum_seed=(3, -4))
    got, want = CascadeParams.create(**kw, device="cpu"), JaxParams.create(**kw)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), err_msg=f.name)


def test_sim_config_validation():
    for bad in (dict(map_size=100), dict(map_size=2), dict(map_dtype="float64"),
                dict(fused="always")):
        with pytest.raises(ValueError):
            SimConfig(**bad)


def test_grid_helpers_equal_jax():
    n = 32
    lx, ly = np.float32(88.0), np.float32(57.0)
    kx, ky = grid.k_grid(n, _t(lx), _t(ly))
    jkx, jky = jgrid.k_grid(n, jnp.float32(lx), jnp.float32(ly))
    np.testing.assert_array_equal(kx.numpy(), np.asarray(jkx))
    np.testing.assert_array_equal(ky.numpy(), np.asarray(jky))
    np.testing.assert_array_equal(grid.sign_shift(n).numpy(), np.asarray(jgrid.sign_shift(n)))
    field = np.random.default_rng(0).standard_normal((2, n, n)).astype(np.float32)
    np.testing.assert_array_equal(grid.negate_wavenumber(_t(field)).numpy(),
                                  np.asarray(jgrid.negate_wavenumber(jnp.asarray(field))))


@pytest.mark.parametrize("cascade", [0, 1, 2])
def test_initial_spectrum_matches_jax(cascade):
    """h0 / h0nc of each default cascade at 64^2: <= 1e-4 relative RMS."""
    from godotoceanwaves_tpu_torch.models.ocean import _spectrum_one
    from godotoceanwaves_tpu.models.ocean import _spectrum_one as jax_spectrum_one
    from godotoceanwaves_tpu.models.cascade import SimConfig as JaxConfig
    import jax
    n = 64
    p = default_cascades(device="cpu").map(lambda x: x[cascade])
    jp = jax.tree.map(lambda x: x[cascade], jax_default_cascades())
    h0, h0nc = _spectrum_one(SimConfig(map_size=n), p)
    jh0, jh0nc = jax_spectrum_one(JaxConfig(map_size=n), jp)
    for got, want in ((h0, jh0), (h0nc, jh0nc)):
        got, want = got.numpy(), np.asarray(want)
        assert rel_rms(got.real, want.real) < 1e-4 and rel_rms(got.imag, want.imag) < 1e-4


def test_spectra_stage_functions_match_jax():
    """The stage functions on shared inputs: <= 1e-5 relative RMS each."""
    r = np.random.default_rng(5)
    w = r.uniform(0.3, 12.0, 4096).astype(np.float32)
    theta = r.uniform(-np.pi, np.pi, 4096).astype(np.float32)
    wp, alpha, u = np.float32(0.9), np.float32(0.01), np.float32(10.0)
    pairs = [
        (spectra.tma_spectrum(_t(w), _t(wp), _t(alpha), 20.0),
         jspectra.tma_spectrum(jnp.asarray(w), wp, alpha, 20.0)),
        (spectra.hasselmann_directional_spread(_t(w), _t(wp), _t(u), _t(theta),
                                               _t(np.float32(0.8)), _t(np.float32(0.3))),
         jspectra.hasselmann_directional_spread(jnp.asarray(w), wp, u, jnp.asarray(theta),
                                                np.float32(0.8), np.float32(0.3))),
        (spectra.dispersion_relation(_t(w), 20.0)[1],
         jspectra.dispersion_relation(jnp.asarray(w), 20.0)[1]),
        (spectra.jonswap_peak_angular_frequency(_t(u), _t(np.float32(1.5e5))),
         jspectra.jonswap_peak_angular_frequency(u, np.float32(1.5e5))),
    ]
    for got, want in pairs:
        assert rel_rms(got.numpy(), np.asarray(want)) < 1e-5


def _planes(r, shape):
    return r.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("use_omega", [True, False])
def test_modulate_planes_matches_jax(use_omega):
    """One cascade's packed layers at t ~ 120 s: <= 1e-5 relative RMS."""
    r = np.random.default_rng(7)
    n = 64
    h0, h0nc = _planes(r, (2, n, n)), _planes(r, (2, n, n))
    tile = np.array([57.0, 57.0], np.float32)
    t = np.float32(123.14159)
    om = spectra.dispersion_grid_host(n, tile, 20.0) if use_omega else None
    got = modulate.modulate_planes(_t(h0), _t(h0nc), _t(tile), 20.0, _t(t),
                                   omega=None if om is None else _t(om))
    want = jmod.modulate_planes(jnp.asarray(h0), jnp.asarray(h0nc), jnp.asarray(tile), 20.0,
                                t, omega=None if om is None else jnp.asarray(om))
    assert got.shape == (4, 2, n, n)
    assert rel_rms(got.numpy(), np.asarray(want)) < 1e-5


@pytest.mark.parametrize("fold_sign", [True, False])
def test_ifft2_packed_planes_matches_jax_xla_tier(fold_sign):
    """rows -> transpose -> rows, unnormalized: <= 1e-5 relative RMS."""
    x = _planes(np.random.default_rng(11), (3, 2, 64, 64))
    got = fft.ifft2_packed_planes(_t(x), fold_sign=fold_sign)
    want = jfft.ifft2_packed_planes(jnp.asarray(x), impl="xla", fold_sign=fold_sign)
    assert rel_rms(got.numpy(), np.asarray(want)) < 1e-5


def test_ifft2_packed_matches_oracle_stockham_chain():
    """The complex form vs the oracle's staged Stockham chain: <= 1e-5."""
    r = np.random.default_rng(13)
    n = 32
    x = (r.standard_normal((4, n, n)) + 1j * r.standard_normal((4, n, n))).astype(np.complex64)
    got = fft.ifft2_packed(_t(x)).numpy()
    want = oracle.reference_fft_chain(x, oracle.butterfly_factors(n))
    assert rel_rms(np.stack([got.real, got.imag]), np.stack([want.real, want.imag])) < 1e-5


@pytest.mark.parametrize("pre_shifted", [True, False])
def test_unpack_planes_matches_jax(pre_shifted):
    """Maps and foam from the same fields: <= 1e-6."""
    r = np.random.default_rng(17)
    n = 32
    fields = _planes(r, (4, 2, n, n)) * 0.5
    foam = r.uniform(0, 1, (n, n)).astype(np.float32)
    args = (np.float32(0.5), np.float32(0.3), np.float32(0.2))
    got = unpack.unpack_planes(_t(fields), _t(foam), *(_t(a) for a in args),
                               pre_shifted=pre_shifted)
    want = junpack.unpack_planes(jnp.asarray(fields), jnp.asarray(foam), *args,
                                 pre_shifted=pre_shifted)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= 1e-6
