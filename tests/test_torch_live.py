"""The port's ANSI live viewer (utils/live.py), on the CPU; twins of
tests/test_utils.py:226-316, at small sizes (maps <= 64^2, frames <= 32 x 16
cells).

Runtime editing goes through `Ocean.set_cascade` (dirty-bit regeneration)
and cascade add/remove through `Ocean.set_cascades`, whose seeds equal the
JAX package's after the same calls (tests/test_torch_session.py). The text
helpers are held to the JAX package's: `ansi_field` and `ansi_rgb` return
the same string for the same arrays, and `_sample_field` agrees within
1e-5.
"""
import io

import numpy as np
import jax.numpy as jnp
import torch

from godotoceanwaves_tpu import Ocean as JOcean
from godotoceanwaves_tpu.utils import live as jlive

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.utils import convert, live as tlive
from godotoceanwaves_tpu_torch.utils.live import LiveViewer


def viewer(ocean, keys, **kw):
    script = iter(keys)
    out = io.StringIO()
    v = LiveViewer(ocean, fps=30.0, input_fn=lambda: next(script, "q"), output=out, **kw)
    return v, out


def test_tables_are_the_jax_packages():
    assert tlive.PARAM_STEPS == jlive.PARAM_STEPS
    assert tlive.RESOLUTIONS == jlive.RESOLUTIONS
    assert tlive.KEY_HELP == jlive.KEY_HELP


def test_live_viewer_runtime_editing():
    """Parameters editable while simulating (main.gd:57-121): cascade
    select, +/- on a field, tab to the next field, update rate, add and
    remove a cascade, quit."""
    ocean = T.Ocean(map_size=32, updates_per_second=0, device="cpu")
    v, out = viewer(ocean, ["2", "+", "+", "\t", "-", "U", "C", "c", "", "q"], cols=24,
                    rows=8)
    w0 = float(ocean.params.wind_speed[1])
    d0 = float(ocean.params.wind_direction[1])
    u0 = ocean.updates_per_second
    v.run(max_frames=20)
    assert float(ocean.params.wind_speed[1]) == w0 + 2.0
    assert float(ocean.params.wind_direction[1]) == d0 - 5.0
    assert ocean.updates_per_second == u0 + 5.0
    assert ocean.num_cascades == 3                    # C then c
    text = out.getvalue()
    assert "wind_direction" in text and "fps" in text
    assert "\x1b[38;2;" in text
    assert v.quit


def test_live_viewer_cascade_add_remove_matches_jax_seeds():
    """'C' adds a default cascade and reseeds the stack from the session
    RNG, 'c' removes the last: the same seeds as the JAX package's viewer
    after the same keys."""
    jo = JOcean(map_size=32, updates_per_second=0)
    to = T.Ocean(params=convert.params_from_numpy(
        {k: np.asarray(getattr(jo.params, k)) for k in T.CascadeParams.__dataclass_fields__},
        device="cpu"), map_size=32, updates_per_second=0, device="cpu")
    for o, cls in ((jo, jlive.LiveViewer), (to, LiveViewer)):
        v = cls(o, cols=8, rows=4, input_fn=lambda: "", output=io.StringIO())
        for ch in "CCc":
            v.handle_key(ch)
    assert to.num_cascades == jo.num_cascades == 4
    np.testing.assert_array_equal(to.params.spectrum_seed.numpy(),
                                  np.asarray(jo.params.spectrum_seed))
    np.testing.assert_array_equal(to.params.wind_speed.numpy(), np.asarray(jo.params.wind_speed))


def test_live_viewer_resolution_cycle():
    ocean = T.Ocean(map_size=128, updates_per_second=0, device="cpu")
    v, _ = viewer(ocean, ["r", "q"], cols=8, rows=4, view="field")
    v.run(max_frames=2)
    assert ocean.config.map_size == 256          # 128 -> 256 (main.gd:68 combo)
    assert v._maps is not None and v._maps.displacement.shape[-1] == 256


def test_live_viewer_fly_camera_and_views():
    """The viewer flies the camera (camera.gd keys), toggles mesh quality,
    and switches between the 3D view and the top-down field."""
    ocean = T.Ocean(map_size=32, updates_per_second=0, device="cpu")
    v, out = viewer(ocean, ["w", "w", "l", "k", "x", "m", "F", "v", "", "v", "q"],
                    cols=20, rows=8)
    pos0 = v.camera.position.copy()
    yaw0, pitch0 = v.camera.yaw, v.camera.pitch
    assert v.view == "3d"
    v.run(max_frames=12)
    assert np.linalg.norm(v.camera.position - pos0) > 1.0
    assert v.camera.yaw != yaw0 and v.camera.pitch != pitch0
    assert v.mesh_quality == "high" and v.view == "3d" and v.camera.fov_deg == 75.0
    text = out.getvalue()
    assert "cam [" in text and "\x1b[38;2;" in text


def test_live_viewer_spray_composites_in_3d_view():
    ocean = T.Ocean(map_size=32, updates_per_second=0, device="cpu")
    v, _ = viewer(ocean, ["", "", "q"], cols=16, rows=6, spray=True, spray_particles=64)
    v.run(max_frames=4)
    assert v._spray.started and v._spray.clock > 0.0
    assert v._spray.device.type == "cpu"


def test_ansi_helpers_match_jax():
    rng = np.random.RandomState(0)
    h = rng.randn(8, 10).astype(np.float32)
    f = np.linspace(0, 1, 80, dtype=np.float32).reshape(8, 10)
    assert tlive.ansi_field(h, f) == jlive.ansi_field(h, f)
    wc, fc = np.array([0.5, 0.05, 0.05], np.float32), np.array([0.9, 0.9, 0.1], np.float32)
    assert tlive.ansi_field(h, f, wc, fc) == jlive.ansi_field(h, f, wc, fc)
    rgb = rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    assert tlive.ansi_rgb(rgb) == jlive.ansi_rgb(rgb)


def test_sample_field_matches_jax():
    jo = JOcean(map_size=32, updates_per_second=0)
    maps = jo.update(1 / 30)
    scales = jo.params.map_scales()
    jh, jf = jlive._sample_field(maps, scales, 88.0, 12, 6)
    tmaps = convert.maps_from_numpy(np.asarray(maps.displacement), np.asarray(maps.normal),
                                    device="cpu")
    th, tf = tlive._sample_field(tmaps, torch.from_numpy(np.array(scales)), 88.0, 12, 6)
    assert tuple(th.shape) == (6, 12)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
    assert jnp.isfinite(jh).all()


def test_graphed_sample_field_matches_jax_jit():
    """The ANSI field as the viewer calls it (`_sample_field_graphed`, one
    captured graph on the card; `fn` as it is on CPU tensors) against the
    JAX package's `_sample_field_jit`, at test_sample_field_matches_jax's
    tolerance."""
    jo = JOcean(map_size=32, updates_per_second=0)
    maps = jo.update(1 / 30)
    scales = jo.params.map_scales()
    jh, jf = jlive._sample_field_jit(maps, scales, 40.0, 10, 8)
    tmaps = convert.maps_from_numpy(np.asarray(maps.displacement), np.asarray(maps.normal),
                                    device="cpu")
    th, tf = tlive._sample_field_graphed(tmaps, torch.from_numpy(np.array(scales)), 40.0, 10, 8)
    assert tuple(th.shape) == (8, 10)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5, atol=1e-5)
