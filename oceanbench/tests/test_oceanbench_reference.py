"""The benchmark's reference against its frozen oracle, at sizes the oracle's
staged NumPy chain runs in a test."""
import numpy as np
import pytest
import torch

from oceanbench.core import spec
from oceanbench.reference import oracle
from oceanbench.reference.ocean import RefOcean

CONFIG = {"map_size": 16, "map_dtype": "bfloat16", "depth": 20.0, "g": 9.81,
          "spectrum_seed_range": [-10000, 10000],
          "cascades": [{"tile_length": [88.0, 88.0], "displacement_scale": 1.0,
                        "normal_scale": 1.0, "wind_speed": 10.0, "wind_direction": 20.0,
                        "fetch_length": 150.0, "swell": 0.8, "spread": 0.2, "detail": 1.0,
                        "whitecap": 0.5, "foam_amount": 8.0},
                       {"tile_length": [16.0, 16.0], "displacement_scale": 0.0,
                        "normal_scale": 0.25, "wind_speed": 20.0, "wind_direction": -40.0,
                        "fetch_length": 550.0, "swell": 1.8, "spread": 0.4, "detail": 0.6,
                        "whitecap": 0.25, "foam_amount": 3.0}]}


def oracle_update(s, n, depth, t, dt, foam):
    u, f_m = np.float32(s["wind_speed"]), np.float32(s["fetch_length"]) * np.float32(1e3)
    tile = tuple(np.float32(v) for v in s["tile_length"])
    h0, h0nc = oracle.packed_spectrum_loop(
        n, s["spectrum_seed"], tile, alpha=oracle.jonswap_alpha(u, f_m),
        w_p=oracle.jonswap_peak_angular_frequency(u, f_m), wind_speed=u,
        angle=np.float32(s["wind_direction"]) * np.float32(np.pi / 180), depth=depth,
        swell=np.float32(s["swell"]), detail=np.float32(s["detail"]),
        spread=np.float32(s["spread"]))
    layers = oracle.modulate(h0, h0nc, tile, depth, t)
    out = oracle.reference_fft_chain(layers, oracle.butterfly_factors(n))
    amount = float(np.float32(s["foam_amount"]))
    return oracle.unpack(out, foam, float(np.float32(s["whitecap"])), dt * amount * 7.5,
                         dt * max(0.5, 10.0 - amount) * 1.15)


def rel(a, b):
    a = np.asarray(a)
    a = a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_vectorized_minus_k_equals_the_loop():
    args = dict(seed=(-4321, 77), tile_length=(57.0, 57.0), alpha=0.01, w_p=1.3,
                wind_speed=5.0, angle=0.3, depth=20.0, swell=0.8, detail=1.0, spread=0.4)
    for n in (8, 16, 32):
        a, b = oracle.packed_spectrum(n, **args), oracle.packed_spectrum_loop(n, **args)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_stockham_chain_is_the_transposed_unnormalized_ifft2():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 16, 16)) + 1j * rng.standard_normal((4, 16, 16))).astype(np.complex64)
    got = oracle.reference_fft_chain(x, oracle.butterfly_factors(16))
    want = np.swapaxes(np.fft.ifft2(x.astype(np.complex128)) * 256, -2, -1)
    assert rel(got, want) < 1e-6


@pytest.mark.parametrize("updates", [1, 3])
def test_reference_agrees_with_the_oracle(updates):
    n, dt = CONFIG["map_size"], 1 / 60
    specs = spec.cascade_specs(CONFIG, 2 ** 31 + 5)
    ref = RefOcean(CONFIG, specs, dt, "cpu")
    for c, s in enumerate(specs):
        foam_ref = torch.zeros((n, n), dtype=torch.float64)
        foam_or = np.zeros((n, n), np.float32)
        for u in range(updates):
            disp, normal, foam_ref = ref.step(c, foam_ref, u)
            d, nm, foam_or = oracle_update(s, n, ref.depth, ref.time(u)[c], dt, foam_or)
        assert rel(disp.permute(1, 2, 0).numpy(), d) < 2e-6
        assert rel(normal.permute(1, 2, 0).numpy(), nm) < 2e-6
        assert float(np.abs(foam_ref.numpy() - foam_or).max()) < 1e-6


def test_time_advances_one_fp32_add_an_update():
    ref = RefOcean(CONFIG, spec.cascade_specs(CONFIG, 1), 1 / 60, "cpu")
    t = np.float32(np.float32(120.0) + np.float32(np.float32(np.pi) * np.float32(1)))
    for u in range(50):
        t = np.float32(t + np.float32(1 / 60))
        assert ref.time(u)[1] == t


def test_the_control_is_one_precision_lower():
    specs = spec.cascade_specs(CONFIG, 9)
    ref = RefOcean(CONFIG, specs, 1 / 60, "cpu")
    zero = torch.zeros((16, 16), dtype=torch.float64)
    d, _, _ = ref.step(0, zero, 4)
    dc, _, _ = ref.control_step(0, zero, 4)
    q = ref.as_map_dtype(d)
    assert rel(dc.numpy(), d.numpy()) > 10 * rel(q.numpy(), d.numpy())
    assert torch.equal(dc, dc.to(torch.float8_e4m3fn).double())
