"""Long-horizon and statistical-physics checks of the port (the full
Tessendorf loop), on the CPU. The twin of tests/test_longrun.py, with its
cases, sizes and bounds: 3 full frames against the staged NumPy oracle in
both seed modes (<= 1e-4 relative RMS for displacement and normal, foam
<= 1e-4 RMS), and against the JAX package's `step` on the same inputs
(the same bounds); 1000 frames stay finite, foam in [0, 1] and height
statistics stationary; the finest cascade's heights near-Gaussian (the
maps within 1e-4 relative RMS of the JAX package's).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import godotoceanwaves_tpu as J

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models.ocean import multi_step

import oracle

N = 64


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-9, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


@pytest.mark.parametrize("godot_seeds", [False, True])
def test_multi_step_full_loop_parity_with_oracle(godot_seeds):
    """3 full frames (modulate -> 2D IFFT -> unpack with the foam
    recurrence) of cascade 0 against the oracle, and all cascades against
    the JAX package's step from the same params. godot_seeds=True draws
    the Godot-stream preset seeds (water.gd:31): negative and large seed
    values through every stage of the hash."""
    cfg = T.SimConfig(map_size=N)
    params = T.default_cascades(godot_seeds=godot_seeds, device="cpu")
    jp = J.default_cascades(godot_seeds=godot_seeds)
    np.testing.assert_array_equal(params.spectrum_seed.numpy(), np.asarray(jp.spectrum_seed))
    state = T.init_state(cfg, params)
    jcfg = J.SimConfig(map_size=N, fft_impl="xla")
    js = J.init_state(jcfg, jp)
    dt = 0.1
    for _ in range(3):
        state, maps = T.step(cfg, state, params, dt)
        js, jm = J.step(jcfg, js, jp, dt)

    p0 = params.map(lambda x: x[0])
    u, f_m = float(p0.wind_speed), float(p0.fetch_length) * 1e3
    tile = tuple(float(v) for v in p0.tile_length)
    h0, h0nc = oracle.packed_spectrum(
        N, tuple(int(v) for v in p0.spectrum_seed), tile,
        alpha=float(oracle.jonswap_alpha(u, f_m)),
        w_p=float(oracle.jonswap_peak_angular_frequency(u, f_m)), wind_speed=u,
        angle=np.deg2rad(float(p0.wind_direction)).astype(np.float32),
        depth=cfg.depth, swell=float(p0.swell), detail=float(p0.detail),
        spread=float(p0.spread))
    factors = oracle.butterfly_factors(N)
    foam = np.zeros((N, N), np.float32)
    t = 120.0
    grow = dt * float(p0.foam_amount) * 7.5
    decay = dt * max(0.5, 10.0 - float(p0.foam_amount)) * 1.15
    for _ in range(3):
        t += dt
        layers = oracle.modulate(h0, h0nc, tile, cfg.depth, t)
        out = oracle.reference_fft_chain(layers, factors)
        disp_ref, norm_ref, foam = oracle.unpack(out, foam, float(p0.whitecap), grow, decay)

    assert rel_rms(maps.displacement[0].numpy().transpose(1, 2, 0), disp_ref) < 1e-4
    assert rel_rms(maps.normal[0].numpy().transpose(1, 2, 0), norm_ref) < 1e-4
    assert rms(state.foam[0].numpy(), foam) < 1e-4

    assert rel_rms(maps.displacement.numpy(), jm.displacement) < 1e-4
    assert rel_rms(maps.normal.numpy(), jm.normal) < 1e-4
    assert rms(state.foam.numpy(), js.foam) < 1e-4


def test_long_horizon_stability():
    """1000 frames (20 multi_step calls of 50): foam stays bounded, height
    statistics stay stationary; the first call's maps match the JAX
    package's multi_step from the same state (1e-4 relative RMS)."""
    cfg = T.SimConfig(map_size=N)
    params = T.default_cascades(device="cpu")
    state = T.init_state(cfg, params)
    dt = 1 / 30

    jp = J.default_cascades()
    jcfg = J.SimConfig(map_size=N)
    js = J.models.OceanState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                                for f in dataclasses.fields(state)})
    _, jm = J.models.multi_step(jcfg, js, jp, np.float32(dt), 50)

    state, maps = multi_step(cfg, state, params, dt, 50)
    assert rel_rms(maps.displacement.numpy(), jm.displacement) < 1e-4
    early_std = float(maps.displacement[:, 1].std(unbiased=False))
    for _ in range(19):
        state, maps = multi_step(cfg, state, params, dt, 50)
    late_std = float(maps.displacement[:, 1].std(unbiased=False))
    foam = state.foam.numpy()

    assert np.isfinite(maps.displacement.numpy()).all()
    assert 0.0 <= foam.min() and foam.max() <= 1.0
    # stationary process: height rms at t~153 s within 2x of t~122 s
    assert 0.5 < late_std / early_std < 2.0


def test_height_field_is_approximately_gaussian():
    """Linear superposition of many independent modes => near-Gaussian heights.

    The finest cascade (16 m tile) has the most independent modes in band;
    a single realization of the long-tile cascades carries visible
    small-sample skew, which is physics, not a fault."""
    cfg = T.SimConfig(map_size=128)
    params = T.default_cascades(device="cpu")
    state = T.init_state(cfg, params)
    _, maps = T.step(cfg, state, params, 0.02)
    jcfg = J.SimConfig(map_size=128, fft_impl="xla")
    jp = J.default_cascades()
    _, jm = J.step(jcfg, J.init_state(jcfg, jp), jp, 0.02)
    assert rel_rms(maps.displacement.numpy(), jm.displacement) < 1e-4
    h = maps.displacement[2, 1].numpy().ravel().astype(np.float64)
    h = (h - h.mean()) / (h.std() + 1e-12)
    skew = float(np.mean(h ** 3))
    kurt = float(np.mean(h ** 4))
    assert abs(skew) < 0.5
    assert 2.0 < kurt < 4.5  # Gaussian = 3
