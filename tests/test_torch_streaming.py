"""Config-5 capabilities in the port: the dual wind + swell preset and host
map streaming. The four behaviours of tests/test_streaming_presets.py, run on
the port's `Ocean` on the CPU, plus the preview tier against the JAX
package's `x[..., ::2, ::2].astype(bfloat16)` of the same maps (bit-equal:
both round the same fp32 values once to bf16)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.models import dual_wind_swell_cascades as jax_dual_wind_swell

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import dual_wind_swell_cascades
from godotoceanwaves_tpu_torch.utils import MapStreamer, convert, preview_maps

N = 64


def test_dual_wind_swell_preset():
    params = dual_wind_swell_cascades(device="cpu")
    assert params.num_cascades == 2
    ocean = T.Ocean(params=params, map_size=N, updates_per_second=0, device="cpu")
    for _ in range(5):
        maps = ocean.update(0.05)
    d = maps.displacement.numpy()
    assert np.isfinite(d).all()
    assert d[1, 1].std() > 0.0 and d[0, 1].std() > 0.0
    jp = jax_dual_wind_swell()
    for f in dataclasses.fields(jp):
        np.testing.assert_array_equal(getattr(params, f.name).numpy(), np.asarray(getattr(jp, f.name)))


def test_map_streamer_overlaps_and_preserves_order():
    ocean = T.Ocean(map_size=N, updates_per_second=0, device="cpu")
    heights, direct = [], []

    def step():
        maps = ocean.update(0.1)
        direct.append(maps.displacement[0, 1].numpy().std())
        return maps

    streamer = MapStreamer(step)
    for host in streamer.stream(num_frames=4):
        assert host["displacement"].shape == (3, 3, N, N)
        assert host["normal"].dtype == np.float32
        heights.append(host["displacement"][0, 1].std())
    streamer.close()
    assert len(heights) == 4
    np.testing.assert_array_equal(heights, direct)       # in order
    assert len({round(float(h), 6) for h in heights}) > 1


def test_map_streamer_native_dtype_and_host_conversion():
    """The yielded arrays default to fp32; host_dtype=None keeps the native
    dtype, as CPU tensors (NumPy has no bfloat16)."""
    ocean = T.Ocean(map_size=N, updates_per_second=0, map_dtype="bfloat16", device="cpu")
    streamer = MapStreamer(lambda: ocean.update(0.1))
    host = next(iter(streamer.stream(num_frames=1)))
    streamer.close()
    assert isinstance(host["displacement"], np.ndarray)
    assert host["displacement"].dtype == np.float32
    assert np.isfinite(host["displacement"]).all()

    streamer = MapStreamer(lambda: ocean.update(0.1), host_dtype=None)
    host = next(iter(streamer.stream(num_frames=1)))
    streamer.close()
    assert isinstance(host["displacement"], torch.Tensor)
    assert host["displacement"].dtype == torch.bfloat16
    assert host["displacement"].device.type == "cpu"
    np.testing.assert_array_equal(host["displacement"].float().numpy(),
                                  ocean.maps.displacement.float().numpy())


def test_map_streamer_handles_rate_limited_updates():
    ocean = T.Ocean(map_size=N, updates_per_second=10.0, device="cpu")
    streamer = MapStreamer(lambda: ocean.update(0.02))
    got = list(streamer.stream(num_frames=2))
    streamer.close()
    assert len(got) == 2  # skipped frames (None) are absorbed, not yielded


def test_preview_tier_matches_jax():
    """Bit-equal to JAX's preview of the same maps, and within one bf16 step
    of it on the port's own maps (which agree with JAX's to ~1e-7)."""
    jo = J.Ocean(params=jax_dual_wind_swell(), map_size=N, updates_per_second=0)
    leaves = {f.name: np.asarray(getattr(jo.params, f.name)) for f in dataclasses.fields(jo.params)}
    to = T.Ocean(params=convert.params_from_numpy(leaves, device="cpu"), map_size=N, updates_per_second=0,
                 device="cpu")
    jm, tm = jo.update(0.05), to.update(0.05)
    j_prev = jax.tree.map(lambda x: x[..., ::2, ::2].astype(jnp.bfloat16), jm)
    same = preview_maps(T.OceanMaps(displacement=torch.from_numpy(np.array(jm.displacement)),
                                    normal=torch.from_numpy(np.array(jm.normal))))
    own = preview_maps(tm)
    assert preview_maps(None) is None
    for name, channels in (("displacement", 3), ("normal", 4)):
        want = np.asarray(getattr(j_prev, name))
        for got in (getattr(same, name), getattr(own, name)):
            assert got.dtype == torch.bfloat16 and got.is_contiguous()
            assert tuple(got.shape) == want.shape == (2, channels, N // 2, N // 2)
        np.testing.assert_array_equal(getattr(same, name).view(torch.int16).numpy(),
                                      want.view(np.int16))
        ref = want.astype(np.float32)
        diff = np.abs(getattr(own, name).float().numpy() - ref)
        assert np.all(diff <= np.abs(ref) * 2 ** -7 + 1e-6)
