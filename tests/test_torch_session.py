"""The rest of the port's `Ocean` session vs the JAX package's, on the CPU.

Twins of tests/test_simulation.py:19 (runtime cascade add/remove), :255
(restore validates the snapshot), :274 (checkpoint round trip) and :369
(the session's global colours), plus the tree moves of `utils/hostio.py`.
Parameters cross over as NumPy arrays (utils/convert.py). Tolerances:
spectrum seeds equal; h0/h0nc within 1e-4 relative RMS and maps within the
bounds of tests/test_torch_slice.py (maps <= 1e-4 relative RMS, foam <= 1e-4
RMS); a restored session's next maps equal to the unbroken run's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import godotoceanwaves_tpu as J
import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import shading as tshading
from godotoceanwaves_tpu_torch.utils import convert, hostio

N = 64


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def pair(n=N):
    jo = J.Ocean(map_size=n, updates_per_second=0)
    to = T.Ocean(params=convert.params_from_numpy(leaves(jo.params), device="cpu"),
                 map_size=n, updates_per_second=0, device="cpu")
    return jo, to


def test_set_cascades_reseeds_like_jax():
    """water.gd:22-35: every set_cascades draws fresh seeds from the session
    RNG (seed 1234) and restarts time at 120 + pi*i; the port's draws equal
    the JAX package's after the same calls, and so do the spectra."""
    jo, to = pair()
    specs = [(88.0, 10.0), (57.0, 5.0), (16.0, 20.0), (200.0, 15.0)]
    jo.set_cascades([J.CascadeParams.create(tile_length=L, wind_speed=W) for L, W in specs])
    to.set_cascades([T.CascadeParams.create(tile_length=L, wind_speed=W, device="cpu")
                     for L, W in specs])
    assert to.num_cascades == 4 and to.maps.displacement.shape == (4, 3, N, N)
    np.testing.assert_array_equal(to.params.spectrum_seed.numpy(),
                                  np.asarray(jo.params.spectrum_seed))
    assert to.params.spectrum_seed.dtype == torch.int32
    np.testing.assert_array_equal(to.state.time.numpy(), np.asarray(jo.state.time))
    np.testing.assert_allclose(to.state.time.numpy(), 120.0 + np.pi * np.arange(4), rtol=1e-6)
    for name in ("h0", "h0nc"):
        assert rel_rms(getattr(to.state, name).numpy(), getattr(jo.state, name)) <= 1e-4
    jm, tm = jo.update(0.02), to.update(0.02)
    assert rel_rms(tm.displacement.numpy(), jm.displacement) <= 1e-4
    assert rel_rms(tm.normal.numpy(), jm.normal) <= 1e-4

    # shrink to 1: the RNG stream continues in both
    jo.set_cascades([J.CascadeParams.create(tile_length=100.0, wind_speed=12.0)])
    to.set_cascades([T.CascadeParams.create(tile_length=100.0, wind_speed=12.0, device="cpu")])
    np.testing.assert_array_equal(to.params.spectrum_seed.numpy(),
                                  np.asarray(jo.params.spectrum_seed))
    assert to.update(0.02).displacement.shape == (1, 3, N, N)

    # reseed=False keeps the caller's seeds
    to.set_cascades([T.CascadeParams.create(tile_length=50.0, spectrum_seed=(7, -3),
                                            device="cpu")], reseed=False)
    assert to.params.spectrum_seed.tolist() == [[7, -3]]


def test_checkpoint_restore_roundtrip():
    """A restored session's next update equals the unbroken run's, bit for
    bit (tests/test_simulation.py:274)."""
    ocean = T.Ocean(map_size=N, updates_per_second=0, device="cpu")
    ocean.update(0.02)
    ocean.water_color = np.array([0.5, 0.05, 0.05], np.float32)
    snap = ocean.checkpoint()
    assert all(t.device.type == "cpu" for t in dataclasses.asdict(snap["state"]).values())
    assert snap["state"].h0.dtype == torch.float32       # fp32 planes, no complex pairs
    assert snap["state"].foam.data_ptr() != ocean.state.foam.data_ptr()
    maps_a = ocean.update(0.02).displacement

    fresh = T.Ocean(map_size=N, updates_per_second=0, device="cpu")
    fresh.restore(snap)
    np.testing.assert_allclose(fresh.water_color, [0.5, 0.05, 0.05])
    maps_b = fresh.update(0.02).displacement
    torch.testing.assert_close(maps_b, maps_a, rtol=0, atol=0)


def test_restore_validates_snapshot_shape():
    """A different map size resizes; a different cascade count raises
    (tests/test_simulation.py:255)."""
    ocean = T.Ocean(map_size=N, updates_per_second=0, device="cpu")
    ocean.update(0.02)
    snap = ocean.checkpoint()

    bigger = T.Ocean(map_size=2 * N, updates_per_second=0, device="cpu")
    bigger.restore(snap)
    assert bigger.config.map_size == N
    assert bigger.maps.displacement.shape == (3, 3, N, N)
    assert bigger.update(0.02) is not None

    two = T.Ocean(params=[T.CascadeParams.create(device="cpu"),
                          T.CascadeParams.create(tile_length=31.0, device="cpu")],
                  map_size=N, updates_per_second=0, device="cpu")
    with pytest.raises(ValueError, match="cascades"):
        two.restore(snap)


def test_snapshot_crosses_between_packages():
    """The JAX package's snapshot of the same session holds the same
    schedule and params as the port's; its state restored into the port
    continues like the JAX session (tests/test_torch_slice.py's bounds)."""
    jo, to = pair()
    for o in (jo, to):
        o.update(0.02)
        o.update(0.03)
    js, ts = jo.checkpoint(), to.checkpoint()
    for key in ("map_size", "num_cascades", "time", "next_update_time", "pending",
                "round_dt"):
        assert ts[key] == js[key], key
    np.testing.assert_allclose(ts["water_color"], js["water_color"])
    np.testing.assert_array_equal(ts["params"].wind_speed.numpy(), js["params"].wind_speed)
    fresh = T.Ocean(map_size=N, updates_per_second=0, device="cpu")
    fresh.restore(dict(ts, state=convert.state_from_numpy(leaves(js["state"]), device="cpu")))
    jm, tm = jo.update(0.02), fresh.update(0.02)
    assert rel_rms(tm.displacement.numpy(), jm.displacement) <= 1e-4
    assert float(np.sqrt(np.mean((fresh.state.foam.numpy() - np.asarray(jo.state.foam)) ** 2))) \
        <= 1e-4


def test_session_colors_and_resize_flag():
    """The session owns the global colours (water.gd:14-18), from shading's
    defaults; resize accepts the JAX package's clear_jit_caches and ignores
    it."""
    ocean = T.Ocean(map_size=16, updates_per_second=0, device="cpu")
    jocean = J.Ocean(map_size=16, updates_per_second=0)
    np.testing.assert_array_equal(ocean.water_color, jocean.water_color)
    np.testing.assert_array_equal(ocean.foam_color, jocean.foam_color)
    np.testing.assert_allclose(ocean.water_color, tshading.DEFAULT_WATER_COLOR)
    assert ocean.water_color.dtype == np.float32
    ocean.resize(32, clear_jit_caches=False)
    assert ocean.maps.displacement.shape == (3, 3, 32, 32)


def test_tree_moves():
    """device_get_tree / device_put_tree move dataclasses, dicts, lists and
    tuples of tensors (and NumPy leaves on the way in), keep dtypes, copy,
    and pass other leaves through."""
    cls = T.SimConfig  # a non-tensor leaf (a dataclass type)
    tree = {"a": [torch.arange(3, dtype=torch.int32), (np.ones(2, np.bool_), 1.5)],
            "b": T.CascadeParams.create(device="cpu"), "c": cls, "d": None}
    got = hostio.device_get_tree(tree)
    assert got["a"][0].dtype == torch.int32 and got["a"][1][1] == 1.5 and got["c"] is cls
    assert got["a"][0].data_ptr() != tree["a"][0].data_ptr()
    assert isinstance(got["b"], T.CascadeParams) and got["d"] is None
    put = hostio.device_put_tree(tree, "cpu")
    assert put["a"][1][0].dtype == torch.bool and isinstance(put["a"][1], tuple)
    assert torch.equal(put["b"].wind_speed, tree["b"].wind_speed)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            hostio.device_put_tree(tree)
