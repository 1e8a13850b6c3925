"""The port's browser viewer (utils/webviewer.py) on the CPU.

Twins of tests/test_webviewer.py (all 17), of tests/test_viewport.py:80
(JPEG hue) and :166 (viewer checkpoint), and of the viewer part of
tests/test_simulation.py:389-395 (session colours), at small sizes: 64^2
maps, 64x36 frames, at most 256 spray particles. The twins drive real
threads and sockets; each stops its viewer in a `finally` and each polling
loop has a 20 s deadline (the JAX twins' 60 s cover XLA compiles that eager
PyTorch does not have, and they are marked slow for them; these are not).

Held against the JAX package's viewer, with the same params carried
across by `utils/convert.params_from_numpy`: `PARAM_RANGES` and the
formatted `_PAGE` equal; `_state()` with the same keys; `_snapshot_ocean()`
within 1e-6 after the same `_apply` edits; `_frame_bytes` through PIL
byte-equal for the same array; one frame of each viewer's renderer at the
renderer's tolerance (tests/test_torch_render.py:9-12: mean |delta| < 2e-3,
here over the uint8 frame / 255). The standard-library PNG (what a machine
without PIL serves) decodes exactly, through PIL and through the zlib reader
below, for both row filters.
"""
import contextlib
import dataclasses
import io
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
import wave
import zlib
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu import Ocean as JOcean
from godotoceanwaves_tpu.utils import webviewer as jwv

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models.viewport import (_rgb_to_yuv420, ycbcr_to_rgb,
                                                       yuv420_to_ycbcr)
from godotoceanwaves_tpu_torch.ops import _build
from godotoceanwaves_tpu_torch.utils import convert
from godotoceanwaves_tpu_torch.utils import webviewer as twv
from godotoceanwaves_tpu_torch.utils.webviewer import PARAM_RANGES, WebViewer

ROOT = Path(__file__).resolve().parent.parent
DEADLINE = 20.0


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Small frames on one intra-op thread: a viewer's threads beside test
    workers on every core slow to a crawl with one thread a core each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def ocean(map_size=64, **kw):
    return T.Ocean(map_size=map_size, updates_per_second=0, device="cpu", **kw)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=20) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/set",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=20) as r:
        return r.status


def _state(port):
    return json.loads(_get(port, "/state")[2])


def _post_code(port, body):
    try:
        return _post(port, body)
    except urllib.error.HTTPError as e:
        return e.code


def wait_for(port, cond, timeout=DEADLINE):
    """Poll /state until cond(state) holds or the deadline passes; returns
    the last state."""
    deadline = time.time() + timeout
    state = _state(port)
    while not cond(state) and time.time() < deadline:
        time.sleep(0.05)
        state = _state(port)
    return state


@contextlib.contextmanager
def serving(viewer):
    port = viewer.start(port=0)   # ephemeral
    try:
        yield port
    finally:
        viewer.stop()


# --- twins of tests/test_webviewer.py ----------------------------------------

def test_webviewer_serves_and_edits_parameters():
    o = ocean()
    viewer = WebViewer(o, fps=30.0, width=64, height=36)
    with serving(viewer) as port:
        status, ctype, page = _get(port, "/")
        assert status == 200 and "text/html" in ctype
        assert b"ocean panel" in page
        for name in PARAM_RANGES:
            assert name.encode() in page

        state = _state(port)
        assert len(state["cascades"]) == 3 and state["map_size"] == 64
        assert set(state["cascades"][0]) == set(PARAM_RANGES)

        # edit wind speed on cascade 1 through the HTTP surface
        assert _post(port, {"cascade": 1, "name": "wind_speed", "value": 33.0}) == 200
        assert float(o.params.wind_speed[1]) == 33.0
        # spectrum-affecting edit marks the cascade dirty (gd setter semantics)
        assert o._dirty[1] and not o._dirty[0]

        # update-rate + frame production
        assert _post(port, {"name": "updates_per_second", "value": 24.0}) == 200
        assert o.updates_per_second == 24.0
        state = wait_for(port, lambda s: s["frame"] >= 2)
        assert state["frame"] >= 2, "sim thread produced no frames"
        status, ctype, body = _get(port, "/frame.png")
        assert status == 200 and ctype in ("image/jpeg", "image/png")
        if ctype == "image/png":
            assert body[:8] == b"\x89PNG\r\n\x1a\n"
        else:                       # JPEG SOI marker
            assert body[:2] == b"\xff\xd8"

        # global colour pickers (water.gd:14-18; sRGB in -> linear stored)
        assert _post(port, {"name": "water_color", "value": [1.0, 0.5, 0.0]}) == 200
        np.testing.assert_allclose(_state(port)["water_color"],
                                   np.array([1.0, 0.5, 0.0]) ** 2.2, atol=1e-5)

        # runtime cascade add/remove through the panel (water.gd:22-35)
        assert _post(port, {"name": "num_cascades", "value": 4}) == 200
        assert o.num_cascades == 4 and o.params.device == o.device
        assert len(_state(port)["cascades"]) == 4
        assert _post(port, {"name": "num_cascades", "value": 2}) == 200
        assert o.num_cascades == 2

        # bad requests are client errors, not crashes
        assert _post_code(port, {"name": "nope", "value": 1}) == 400


def test_webviewer_fly_camera_and_spray():
    """The browser surface drives the reference's fly camera
    (camera.gd:15-47) and the spray system (main.tscn:133-140)."""
    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36, spray=False,
                       spray_particles=256)
    with serving(viewer) as port:
        state = _state(port)
        assert state["mesh_quality"] == "low" and state["spray"] is False
        pos0 = np.asarray(state["camera"])
        yaw0, pitch0 = viewer.camera.yaw, viewer.camera.pitch

        # pointer-drag look: yaw/pitch move with the camera.gd sensitivity
        assert _post(port, {"name": "camera_look", "value": [40, -20]}) == 200
        assert viewer.camera.yaw == yaw0 - 40 * 0.005
        assert viewer.camera.pitch == pitch0 + 20 * 0.005

        # WASD move in the look frame; wheel speed scaling
        assert _post(port, {"name": "camera_move", "value": [1, 0, 0, 0, 0.5]}) == 200
        assert np.linalg.norm(np.asarray(_state(port)["camera"]) - pos0) > 1.0
        speed0 = viewer.camera.speed
        assert _post(port, {"name": "camera_speed", "value": 2}) == 200
        assert viewer.camera.speed > speed0

        # spray toggle: the state machine advances in the sim loop
        assert _post(port, {"name": "spray", "value": True}) == 200
        frames0 = _state(port)["frame"]
        s = wait_for(port, lambda s: s["frame"] >= frames0 + 2 and viewer._spray.started)
        assert viewer._spray.started, "spray never advanced"
        assert s["spray"] is True

        # mesh quality switch rebuilds the renderer
        assert _post(port, {"name": "mesh_quality", "value": "high"}) == 200
        assert _state(port)["mesh_quality"] == "high"
        assert viewer._viewport.mesh_quality == "high"


def test_webviewer_frames_track_camera_motion():
    """Flying the camera changes the served frame (the pose is a render
    argument, not a constant of the renderer)."""
    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36)
    with serving(viewer) as port:
        wait_for(port, lambda s: s["frame"] >= 2)
        frame_a = _get(port, "/frame.png")[2]
        f0 = _state(port)["frame"]
        assert _post(port, {"name": "camera_look", "value": [400, -120]}) == 200
        assert _post(port, {"name": "camera_move", "value": [1, 0, 1, 1, 1.0]}) == 200
        assert wait_for(port, lambda s: s["frame"] >= f0 + 2)["frame"] >= f0 + 2
        frame_b = _get(port, "/frame.png")[2]
        assert frame_a != frame_b


def test_webviewer_serves_wind_mixed_ambience():
    """The browser surface carries the reference's ambience (main.gd:39-44):
    seamless loop endpoints + the wind-speed dB mix law in /state."""
    from godotoceanwaves_tpu_torch.utils.audio import ambience_gains_db

    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36)
    with serving(viewer) as port:
        for which in ("ocean", "wind"):
            status, ctype, body = _get(port, f"/ambience/{which}.wav")
            assert status == 200 and ctype == "audio/wav"
            with wave.open(io.BytesIO(body)) as w:
                assert w.getnchannels() == 1 and w.getsampwidth() == 2
                assert w.getnframes() == w.getframerate() * 8  # 8 s loop
        # second fetch serves the cached bytes
        assert _get(port, "/ambience/ocean.wav")[2] == _get(port, "/ambience/ocean.wav")[2]

        page = _get(port, "/")[2]
        assert b"/ambience/ocean.wav" in page and b"aud_w" in page

        # /state carries the dB law for the LIVE stack and tracks edits
        state = _state(port)
        total = sum(c["wind_speed"] for c in state["cascades"])
        np.testing.assert_allclose(state["ambience_db"], ambience_gains_db(total), atol=1e-6)
        for i, wind in enumerate((0.0, 0.0, 3.0)):
            assert _post(port, {"cascade": i, "name": "wind_speed", "value": wind}) == 200
        state = _state(port)
        # setter clamps keep zeroed winds at a tiny epsilon -> ~3.0 total
        np.testing.assert_allclose(state["ambience_db"], ambience_gains_db(3.0), atol=0.01)
        # low wind: quiet ocean rumble, loud wind whistle (main.gd:42-43)
        assert state["ambience_db"][0] < state["ambience_db"][1]


def test_webviewer_page_script_sane():
    """The panel page is a %%-formatted template: no leftover tokens,
    balanced delimiters, and each interactive subsystem wired."""
    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36)
    with serving(viewer) as port:
        page = _get(port, "/")[2].decode()
        assert "%(" not in page
        script = page.split("<script>")[1].split("</script>")[0]
        for op, cl in ("{}", "()", "[]"):
            assert script.count(op) == script.count(cl), f"unbalanced {op}{cl}"
        for marker in ("applyAudioGains", "revokeObjectURL", "requestFullscreen",
                       "camera_look", "camera_move", "frameLoop", "rebuildParams"):
            assert marker in script, marker


def test_webviewer_state_warming_stub_never_blocks():
    """/state answers while the sim thread holds the ocean lock through its
    first frame (on the card, the first-use kernel build): with no cached
    snapshot and the lock held, _state returns a host-only warming stub
    after its bounded wait instead of blocking behind the device step."""
    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36)
    assert viewer._state_cache is None
    with viewer._ocean_lock:
        t0 = time.time()
        state = viewer._state()
        took = time.time() - t0
    assert state.get("warming") is True
    assert took < 10.0
    for key in ("cascades", "map_size", "resolutions", "updates_per_second",
                "water_color", "foam_color", "fps", "ms_frame", "frame",
                "camera", "camera_speed", "spray", "mesh_quality", "ambience_db"):
        assert key in state, key
    assert state["cascades"] == [] and state["frame"] == 0
    # once the lock frees, the same call produces (and caches) a real snapshot
    state = viewer._state()
    assert "warming" not in state and len(state["cascades"]) == 3
    assert viewer._state_cache is not None


def test_webviewer_async_resize_keeps_serving(monkeypatch):
    """A map_size change warms in a background thread (held here) while
    old-size frames keep serving, then swaps (main.gd:66-70)."""
    o = ocean()
    viewer = WebViewer(o, fps=30.0, width=64, height=36)
    warm_started = threading.Event()
    warm_release = threading.Event()
    real_warm = WebViewer._warm_one_size

    def slow_warm(self, new_size):
        warm_started.set()
        assert warm_release.wait(DEADLINE), "test never released the warm-up"
        real_warm(self, new_size)

    monkeypatch.setattr(WebViewer, "_warm_one_size", slow_warm)
    port = viewer.start(port=0)
    try:
        wait_for(port, lambda s: s["frame"] >= 2)
        assert _post(port, {"name": "map_size", "value": 128}) == 200
        assert warm_started.wait(DEADLINE), "background warm never started"

        # while the warm-up is held: panel responsive, old size serving
        f0 = _state(port)["frame"]
        t0 = time.time()
        state = _state(port)
        assert time.time() - t0 < 5.0
        assert state["map_size"] == 64 and state["resizing"] is True
        state = wait_for(port, lambda s: s["frame"] > f0 + 1)
        assert state["frame"] > f0 + 1, "frames stalled during resize warm"

        warm_release.set()
        state = wait_for(port, lambda s: s["map_size"] == 128 and not s["resizing"])
        assert state["map_size"] == 128 and state["resizing"] is False
        assert o.config.map_size == 128
        # and frames keep coming at the new size
        f1 = state["frame"]
        assert wait_for(port, lambda s: s["frame"] > f1)["frame"] > f1
    finally:
        warm_release.set()
        viewer.stop()


def test_webviewer_render_tier_switch_async():
    """The render-tier combo swaps the renderer asynchronously: frames keep
    serving while the new tier warms, /state tracks render_tier, and an
    unknown tier is a client error."""
    viewer = WebViewer(ocean(), fps=30.0, width=66, height=36)
    assert viewer.render_tier == "interactive"
    with serving(viewer) as port:
        wait_for(port, lambda s: s["frame"] >= 2)
        assert _post_code(port, {"name": "render_tier", "value": "nope"}) >= 400
        f0 = _state(port)["frame"]
        assert _post(port, {"name": "render_tier", "value": "performance"}) == 200
        state = wait_for(port, lambda s: s["render_tier"] == "performance"
                         and not s["retiering"])
        assert state["render_tier"] == "performance"
        assert state["retiering"] is False
        assert viewer._viewport.render_kwargs["shade_res"] == 3
        assert wait_for(port, lambda s: s["frame"] > f0 + 1)["frame"] > f0 + 1


def test_webviewer_concurrent_resize_and_tier_serialize(monkeypatch):
    """A tier switch posted while a resize warm is in flight is processed
    AFTER the resize by the single reconfiguration worker, so the tier
    renderer warms against the post-resize map size."""
    o = ocean()
    viewer = WebViewer(o, fps=30.0, width=64, height=36)
    warm_started = threading.Event()
    warm_release = threading.Event()
    real_warm = WebViewer._warm_one_size
    real_tier_warm = WebViewer._warm_one_tier
    sizes_seen, tiers_warmed = [], []

    def slow_warm(self, new_size):
        warm_started.set()
        assert warm_release.wait(DEADLINE)
        sizes_seen.append(new_size)
        real_warm(self, new_size)

    def spy_tier_warm(self, tier, scale=None, aa=None):
        tiers_warmed.append((tier, self.ocean.config.map_size))
        real_tier_warm(self, tier, scale, aa)

    monkeypatch.setattr(WebViewer, "_warm_one_size", slow_warm)
    monkeypatch.setattr(WebViewer, "_warm_one_tier", spy_tier_warm)
    port = viewer.start(port=0)
    try:
        wait_for(port, lambda s: s["frame"] >= 2)
        assert _post(port, {"name": "map_size", "value": 128}) == 200
        assert warm_started.wait(DEADLINE)
        # tier request lands while the resize warm is held
        assert _post(port, {"name": "render_tier", "value": "performance"}) == 200
        state = _state(port)
        assert state["resizing"] is True and state["retiering"] is True
        warm_release.set()
        state = wait_for(port, lambda s: s["map_size"] == 128
                         and s["render_tier"] == "performance"
                         and not s["resizing"] and not s["retiering"])
        assert state["map_size"] == 128
        assert state["render_tier"] == "performance"
        assert sizes_seen == [128]
        # the tier warm observed the POST-resize config
        assert tiers_warmed and tiers_warmed[0] == ("performance", 128)
        f0 = state["frame"]
        assert wait_for(port, lambda s: s["frame"] > f0)["frame"] > f0
    finally:
        warm_release.set()
        viewer.stop()


def test_webviewer_combined_size_and_tier_warm_swaps_atomically():
    """_warm_size_and_tier (the worker's both-pending branch) builds ONE
    renderer at the new size and swaps size and tier together."""
    o = ocean()
    viewer = WebViewer(o, fps=30.0, width=64, height=36)
    vp0 = viewer._viewport
    viewer._warm_size_and_tier(128, "performance")
    assert o.config.map_size == 128
    assert viewer.render_tier == "performance"
    assert viewer._viewport is not vp0
    # the swapped state serves: one render on the live config works
    maps = o.update(1 / 30)
    img = viewer._viewport.render(
        maps, o.params.map_scales(), np.zeros(3, np.float32), np.ones(3, np.float32),
        np.array([0.0, 9.0, 0.0], np.float32), -14.0, 0.0)
    assert img.dtype == torch.uint8 and img.numel() == 64 * 36 * 3 // 2   # yuv420 wire


def test_webviewer_fov_control():
    """The reference panel's FOV slider (20-170, main.gd:113-114): /set fov
    updates the render argument, /state reports it, out-of-range values
    clamp, and a wider fov changes the frame."""
    o = ocean()
    viewer = WebViewer(o, width=64, height=36)
    st = viewer._state()
    assert st["fov"] == 70.0
    assert len(st["camera"]) == 3
    assert "camera_pitch" in st and "camera_yaw" in st
    viewer._apply({"name": "fov", "value": 110.0})
    assert viewer.camera.fov_deg == 110.0
    assert viewer._state()["fov"] == 110.0
    viewer._apply({"name": "fov", "value": 500.0})
    assert viewer.camera.fov_deg == 170.0
    viewer._apply({"name": "fov", "value": 3.0})
    assert viewer.camera.fov_deg == 20.0
    pos, pitch, yaw, fov = viewer._camera_args()
    assert fov == 20.0
    maps = o.update(1 / 30)
    scales = o.params.map_scales()
    wc = np.asarray(o.water_color, np.float32)
    fc = np.asarray(o.foam_color, np.float32)
    narrow = viewer._viewport.render(maps, scales, wc, fc, pos, pitch, yaw, fov=20.0)
    wide = viewer._viewport.render(maps, scales, wc, fc, pos, pitch, yaw, fov=150.0)
    assert narrow.shape == wide.shape
    assert (narrow.int() - wide.int()).abs().float().mean() > 1.0
    assert 'id="fov"' in twv._PAGE


def test_webviewer_constructor_validates_render_scale():
    """The constructor accepts exactly the scales the panel combo offers."""
    o = ocean()
    with pytest.raises(ValueError, match="render_scale=5"):
        WebViewer(o, width=60, height=30, render_scale=5)
    with pytest.raises(ValueError, match="flat=True"):
        WebViewer(o, width=64, height=36, flat=True, render_scale=2)
    v = WebViewer(o, width=64, height=36, render_scale=2)
    assert v.render_scale == 2
    assert v._viewport.render_kwargs.get("render_scale") == 2


def test_webviewer_render_scale_switch_async():
    """The render-scale combo: /state lists only divisors of the output
    size, an invalid scale is a client error, a valid one swaps through the
    async worker with frames serving throughout, and a no-op repost clears
    the busy flag."""
    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36)
    assert viewer.render_scale == 1
    with serving(viewer) as port:
        state = wait_for(port, lambda s: s["frame"] >= 2)
        # 3 does not divide 64: offered scales are the divisors only
        assert state["render_scales"] == [1, 2, 4]
        assert _post_code(port, {"name": "render_scale", "value": 3}) >= 400
        f0 = state["frame"]
        assert _post(port, {"name": "render_scale", "value": 2}) == 200
        state = wait_for(port, lambda s: s["render_scale"] == 2 and not s["retiering"])
        assert state["render_scale"] == 2 and state["retiering"] is False
        assert viewer._viewport.render_kwargs.get("render_scale") == 2
        assert wait_for(port, lambda s: s["frame"] > f0 + 1)["frame"] > f0 + 1
        # no-op repost: the worker clears the busy flag
        assert _post(port, {"name": "render_scale", "value": 2}) == 200
        state = wait_for(port, lambda s: not s["retiering"])
        assert state["retiering"] is False
        assert viewer.render_scale == 2


def test_webviewer_frame_batch_validation():
    o = ocean()
    for bad in (0, 9, 2.0, -1):
        with pytest.raises(ValueError):
            WebViewer(o, width=64, height=36, frame_batch=bad)
    # the /set path enforces the SAME type rule as the constructor
    viewer = WebViewer(o, width=64, height=36)
    viewer._apply({"name": "frame_batch", "value": 4})
    assert viewer.frame_batch == 4
    for bad in (12, 0, 2.7, 2.0, True):
        with pytest.raises(KeyError):
            viewer._apply({"name": "frame_batch", "value": bad})
    assert viewer.frame_batch == 4


def test_webviewer_frame_batch_serves_and_falls_back():
    """frame_batch=3 serves K-at-a-time batches; a nonzero update rate
    flips the loop back to single frames live."""
    o = ocean()
    viewer = WebViewer(o, fps=60.0, width=64, height=36, spray=True,
                       spray_particles=256, frame_batch=3)
    with serving(viewer) as port:
        state = wait_for(port, lambda s: s.get("frame", 0) >= 6)
        assert state["frame"] >= 6
        assert state["frame_batch"] == 3
        status, ctype, _ = _get(port, "/frame.png")
        assert status == 200 and ctype in ("image/jpeg", "image/png")
        # sim time advanced in K-sized steps; the spray clock with it
        assert o._time > 0 and viewer._spray.clock > 0

        assert _post(port, {"name": "updates_per_second", "value": 24.0}) == 200
        f0 = _state(port)["frame"]
        assert wait_for(port, lambda s: s["frame"] > f0 + 2)["frame"] > f0 + 2


def test_webviewer_specular_aa_validation():
    """Flat viewers reject specular_aa; geometry viewers carry it into the
    renderer's kwargs."""
    o = ocean()
    with pytest.raises(ValueError, match="flat"):
        WebViewer(o, width=64, height=36, flat=True, specular_aa=True)
    v = WebViewer(o, width=64, height=36, specular_aa=True)
    assert v.specular_aa is True
    assert v._viewport.render_kwargs.get("specular_aa") is True
    vf = WebViewer(o, width=64, height=36, flat=True)
    with pytest.raises(KeyError):
        vf._apply({"name": "specular_aa", "value": True})


def test_webviewer_specular_aa_switch_async():
    """The specular-AA toggle swaps through the async reconfiguration
    worker: /state flips, the live renderer carries the kwarg, frames keep
    serving, and toggling back rebuilds the plain renderer."""
    viewer = WebViewer(ocean(), fps=30.0, width=64, height=36)
    assert viewer.specular_aa is False
    with serving(viewer) as port:
        f0 = wait_for(port, lambda s: s.get("frame", 0) >= 2)["frame"]
        assert _post(port, {"name": "specular_aa", "value": True}) == 200
        state = wait_for(port, lambda s: s["specular_aa"] and not s["retiering"])
        assert state["specular_aa"] is True and state["retiering"] is False
        assert viewer._viewport.render_kwargs.get("specular_aa") is True
        assert wait_for(port, lambda s: s["frame"] > f0 + 1)["frame"] > f0 + 1
        assert _post(port, {"name": "specular_aa", "value": False}) == 200
        state = wait_for(port, lambda s: not s["specular_aa"] and not s["retiering"])
        assert state["specular_aa"] is False
        assert "specular_aa" not in viewer._viewport.render_kwargs


# --- twins of tests/test_viewport.py:80, :166 and tests/test_simulation.py:389-395

def test_jpeg_encode_of_yuv420_preserves_hue():
    """The YCbCr JPEG path decodes back to the original colour (a Cb/Cr
    swap or a wrong matrix would turn the ocean orange)."""
    Image = pytest.importorskip("PIL.Image")
    h, w = 16, 16
    lin = np.zeros((h, w, 3), np.float32)
    lin[..., 2] = 0.7
    lin[..., 1] = 0.2
    srgb = np.clip(lin, 0, 1) ** (1 / 2.2) * 255
    flat = _rgb_to_yuv420(torch.from_numpy(srgb)).numpy()
    body, mime = twv._frame_bytes(yuv420_to_ycbcr(flat, h, w), mode="YCbCr", encoder="jpeg")
    assert mime == "image/jpeg"
    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB")).astype(int)
    direct = srgb.astype(int)
    # JPEG q85 of a flat field: small error, and blue stays dominant
    assert np.max(np.abs(img - direct)) <= 10
    assert (img[..., 2] > img[..., 1]).all() and (img[..., 1] > img[..., 0]).all()


def test_webviewer_session_checkpoint_roundtrip():
    """checkpoint/restore: ocean state, spray state machine and camera pose
    (fov included) resume in a fresh viewer session."""
    o = ocean()
    v = WebViewer(o, width=64, height=36)
    maps = o.update(1 / 30)
    scales = o.params.map_scales()
    for _ in range(4):
        v._spray.advance(maps, scales, 0.5)
    v._apply_camera("camera_move", [1.0, 0.0, 0.0, 0.0, 0.7])
    v._apply_camera("fov", 95.0)
    snap = v.checkpoint()
    assert snap["spray"] is not None and snap["camera"]["fov_deg"] == 95.0

    o2 = ocean()
    v2 = WebViewer(o2, width=64, height=36)
    v2.restore(snap)
    np.testing.assert_allclose(v2.camera.position, v.camera.position)
    assert v2.camera.fov_deg == 95.0
    assert v2._spray.clock == pytest.approx(v._spray.clock)
    assert torch.equal(v2._spray._state.cycle, v._spray._state.cycle)
    assert v2._spray._state.cycle.device == o2.device
    # the restored ocean advances from the checkpointed sim time
    assert float(o2.state.time.max()) == pytest.approx(float(o.state.time.max()))


def test_webviewer_snapshot_reads_the_session_colors():
    """The web panel's snapshot reads the session's one copy of the colours
    (water.gd:14-18), and an edit writes it."""
    o = T.Ocean(map_size=16, updates_per_second=0, device="cpu")
    o.water_color = np.array([0.5, 0.05, 0.05], np.float32)
    viewer = WebViewer(o, width=16, height=12)
    snap = viewer._snapshot_ocean()
    np.testing.assert_allclose(snap["water_color"], o.water_color, atol=1e-6)
    viewer._apply({"name": "foam_color", "value": [1.0, 0.0, 0.0]})
    np.testing.assert_allclose(o.foam_color, [1.0, 0.0, 0.0], atol=1e-6)


# --- the port against the JAX package's viewer ---------------------------------

PARAM_FIELDS = [f.name for f in dataclasses.fields(T.CascadeParams)]
EDITS = [
    {"cascade": 1, "name": "wind_speed", "value": 33.0},
    {"cascade": 0, "name": "tile_length", "value": 120.0},
    {"cascade": 2, "name": "fetch_length", "value": 0.0},      # setter clamp
    {"cascade": 2, "name": "wind_direction", "value": -45.0},
    {"name": "water_color", "value": [1.0, 0.5, 0.0]},
    {"name": "num_cascades", "value": 4},                    # appends defaults
    {"cascade": 3, "name": "swell", "value": 1.5},
    {"name": "num_cascades", "value": 2},
    {"name": "updates_per_second", "value": 24.0},
    {"name": "foam_color", "value": [0.2, 0.9, 0.4]},
]


def twin_oceans(map_size=64):
    """A JAX Ocean and a port Ocean on the CPU with the same params."""
    jo = JOcean(map_size=map_size, updates_per_second=0)
    params = convert.params_from_numpy(
        {name: np.asarray(getattr(jo.params, name)) for name in PARAM_FIELDS}, device="cpu")
    return jo, T.Ocean(params, map_size=map_size, updates_per_second=0, device="cpu")


def test_tables_and_page_are_the_jax_packages():
    assert twv.PARAM_RANGES == jwv.PARAM_RANGES
    assert twv._PAGE == jwv._PAGE
    fill = {"ranges": json.dumps(jwv.PARAM_RANGES), "fps": 20}
    assert twv._PAGE % fill == jwv._PAGE % fill


def test_state_and_snapshot_match_jax_after_the_same_edits():
    jo, to = twin_oceans()
    jv = jwv.WebViewer(jo, width=64, height=36)
    tv = WebViewer(to, width=64, height=36)
    js, ts = jv._state(), tv._state()
    assert set(ts) == set(js)
    for key in ("map_size", "resolutions", "frame", "camera", "fov", "render_scales",
                "render_tier", "frame_batch"):
        assert ts[key] == js[key], key
    for edit in EDITS:
        jv._apply(dict(edit))
        tv._apply(dict(edit))
    want, got = jv._snapshot_ocean(), tv._snapshot_ocean()
    assert set(got) == set(want)
    assert got["map_size"] == want["map_size"] and got["resolutions"] == want["resolutions"]
    assert got["updates_per_second"] == want["updates_per_second"] == 24.0
    assert len(got["cascades"]) == len(want["cascades"]) == 2
    for g, w in zip(got["cascades"], want["cascades"]):
        assert set(g) == set(w) == set(PARAM_RANGES)
        np.testing.assert_allclose([g[k] for k in PARAM_RANGES], [w[k] for k in PARAM_RANGES],
                                   rtol=1e-6, atol=1e-6)
    for key in ("water_color", "foam_color"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6)
    # the edits reached the sessions, seeds included (the session RNG)
    np.testing.assert_array_equal(to.params.spectrum_seed.numpy(),
                                  np.asarray(jo.params.spectrum_seed))


@pytest.mark.parametrize("mode", ["RGB", "YCbCr"])
def test_frame_bytes_through_pil_equal_jax(mode):
    pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:36, 0:64]
    arr = np.stack([xx * 4, yy * 7, (xx + yy) * 2], -1) + rng.integers(0, 16, (36, 64, 3))
    arr = arr.clip(0, 255).astype(np.uint8)
    body, mime = twv._frame_bytes(arr, mode=mode)
    assert mime == "image/jpeg"
    assert (body, mime) == jwv._frame_bytes(arr, mode=mode)


def test_viewer_frame_matches_jax():
    """One frame of each viewer's renderer from the same maps and pose (the
    port's maps, handed to the JAX renderer as arrays)."""
    from godotoceanwaves_tpu.models.ocean import OceanMaps as JMaps
    jo, to = twin_oceans()
    to.set_cascade(0, wind_speed=18.0)
    for _ in range(4):
        tmaps = to.update(1 / 30)
    tscales = to.params.map_scales()
    maps = JMaps(displacement=jnp.asarray(tmaps.displacement.numpy()),
                 normal=jnp.asarray(tmaps.normal.numpy()))
    scales = jnp.asarray(tscales.numpy())
    jv = jwv.WebViewer(jo, width=64, height=36, transfer="rgb", spray_particles=64)
    tv = WebViewer(to, width=64, height=36, transfer="rgb", spray_particles=64)
    for v in (jv, tv):
        v._apply_camera("camera_look", [30, 40])
        v._apply_camera("camera_move", [1.0, 0.3, -0.2, 0.0, 0.5])
    jpos, jpitch, jyaw, jfov = jv._camera_args()
    tpos, tpitch, tyaw, tfov = tv._camera_args()
    np.testing.assert_array_equal(tpos, np.asarray(jpos))
    assert (tpitch, tyaw, tfov) == (float(jpitch), float(jyaw), float(jfov))
    want = np.asarray(jv._viewport.render(maps, scales, jo.water_color, jo.foam_color,
                                          jpos, jpitch, jyaw, fov=jfov))
    got = tv._viewport.render(tmaps, tscales, to.water_color, to.foam_color, tpos, tpitch, tyaw,
                              fov=tfov)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (36, 64, 3)
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.mean() / 255 < 2e-3, f"mean |delta| {diff.mean() / 255:.3e}"


# --- the standard-library PNG -------------------------------------------------

def read_png(body: bytes) -> np.ndarray:
    """A small PNG reader: checks the signature and every chunk's CRC,
    inflates the IDAT data with zlib and undoes filters 0 and 2."""
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(body):
        (n,) = struct.unpack(">I", body[pos:pos + 4])
        kind, data = body[pos + 4:pos + 8], body[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", body[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + data), kind
        chunks.append((kind, data))
        pos += 12 + n
    assert [k for k, _ in chunks][0] == b"IHDR" and chunks[-1] == (b"IEND", b"")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, ctype, comp, filt, interlace) == (8, 2, 0, 0, 0)
    raw = np.frombuffer(zlib.decompress(b"".join(d for k, d in chunks if k == b"IDAT")),
                        np.uint8).reshape(h, w * 3 + 1)
    out = np.zeros((h, w * 3), np.uint8)
    for y in range(h):
        if raw[y, 0] == 0:
            out[y] = raw[y, 1:]
        elif raw[y, 0] == 2:
            out[y] = raw[y, 1:] + (out[y - 1] if y else 0)
        else:
            raise AssertionError(f"filter {raw[y, 0]}")
    return out.reshape(h, w, 3)


def noisy_frame(h=36, w=64, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx * yy) % 256], -1)
    return (smooth + rng.integers(0, 256, (h, w, 3)) * (rng.random((h, w, 1)) < 0.2)) \
        .astype(np.uint8)


@pytest.mark.parametrize("row_filter", [0, 2])
@pytest.mark.parametrize("mode", ["RGB", "YCbCr"])
def test_stdlib_png_decodes_exactly(mode, row_filter):
    arr = noisy_frame()
    want = ycbcr_to_rgb(arr) if mode == "YCbCr" else arr
    body = twv.png_bytes(want, row_filter=row_filter)
    np.testing.assert_array_equal(read_png(body), want)
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))), want)
    # the forced PNG path of _frame_bytes: the same encoder at its defaults
    assert twv._frame_bytes(arr, mode=mode, encoder="png") == (twv.png_bytes(want),
                                                               "image/png")


def test_stdlib_png_levels_and_bad_frames():
    arr = noisy_frame(seed=8)
    sizes = {lvl: len(twv.png_bytes(arr, level=lvl)) for lvl in (0, 1, 9)}
    assert sizes[0] > sizes[1] >= sizes[9]
    for lvl in (0, 9):
        np.testing.assert_array_equal(read_png(twv.png_bytes(arr, level=lvl)), arr)
    # a frame that does not encode raises; it never becomes an empty body
    with pytest.raises(ValueError):
        twv.png_bytes(arr.astype(np.float32))
    with pytest.raises(ValueError):
        twv.png_bytes(arr[..., :2])
    with pytest.raises(ValueError):
        twv.png_bytes(arr, row_filter=1)
    with pytest.raises(ValueError):
        twv._frame_bytes(arr, encoder="gif")
    with pytest.raises(ValueError):
        twv._frame_bytes(arr, mode="RGBA")
    for encoder in ("jpeg", "png"):
        with pytest.raises(ValueError):
            twv._frame_bytes(arr.astype(np.float32), encoder=encoder)


def test_without_jpeg_auto_sends_rgb_png_and_forced_yuv420_still_serves(monkeypatch):
    """Where no JPEG encoder imports (a machine without PIL),
    transfer="auto" resolves to rgb and frames go out as the standard-
    library PNG; a forced yuv420 wire still serves PNGs of the right size."""
    monkeypatch.setattr(twv, "jpeg_available", lambda: False)
    for transfer, wire in (("auto", "rgb"), ("yuv420", "yuv420")):
        viewer = WebViewer(ocean(), fps=30.0, width=64, height=36, transfer=transfer)
        assert viewer._viewport.transfer == wire
        with serving(viewer) as port:
            wait_for(port, lambda s: s["frame"] >= 2)
            _, ctype, body = _get(port, "/frame.png")
        assert ctype == "image/png"
        frame = read_png(body)
        assert frame.shape == (36, 64, 3) and frame.std() > 1.0


# --- devices, the build lock and the demo --------------------------------------

def test_warm_ups_and_edits_create_objects_on_the_oceans_device():
    """Every object the viewer creates takes ocean.device: here the CPU,
    where one made on the default device ("cuda") would raise."""
    o = ocean()
    viewer = WebViewer(o, fps=30.0, width=64, height=36, spray=True, spray_particles=64)
    assert viewer._spray.device == o.device
    viewer._warm_size_and_tier(32, "performance", scale=2)
    viewer._warm_one_tier("interactive")
    viewer._warm_one_size(64)
    viewer._apply({"name": "num_cascades", "value": 5})
    assert o.params.device == o.device and o.num_cascades == 5
    assert not viewer._spray.started     # warm-ups use throwaway spray sessions
    assert (o.config.map_size, viewer.render_tier, viewer.render_scale) == (64, "interactive", 2)


def test_build_load_runs_one_build_for_two_threads(monkeypatch):
    """Two threads that reach `_build.load` first at the same time run one
    build between them (a viewer's frame loop and its warm-up worker)."""
    builds, gate = [], threading.Event()

    def fake_compile():
        builds.append(threading.get_ident())
        gate.wait(5)
        return Path("fake.so"), ""

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(_build, "compile_library", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    _build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(_build.load())) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        gate.set()
        for t in threads:
            t.join(10)
            assert not t.is_alive()
        assert len(builds) == 1 and len(libs) == 2 and libs[0] is libs[1]
        assert libs[0].path == "fake.so"
    finally:
        _build._load.cache_clear()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DEMO_ENV = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": "/tmp",
            "OMP_NUM_THREADS": "1"}


def test_demo_torch_web_serves_on_cpu():
    port = free_port()
    proc = subprocess.Popen([sys.executable, "demo_torch.py", "--cpu", "--web", "--port",
                             str(port), "--map-size", "64", "--width", "64", "--height", "36",
                             "--spray", "--spray-particles", "64"],
                            cwd=str(ROOT), env=DEMO_ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.time() + DEADLINE
        page = None
        while page is None and time.time() < deadline and proc.poll() is None:
            try:
                page = _get(port, "/")[2]
            except OSError:
                time.sleep(0.1)
        assert page is not None and b"ocean panel" in page, proc.poll()
        state = wait_for(port, lambda s: s["frame"] >= 1)
        assert state["frame"] >= 1 and state["spray"] is True and state["map_size"] == 64
        status, ctype, body = _get(port, "/frame.png")
        assert status == 200 and ctype in ("image/jpeg", "image/png") and len(body) > 100
    finally:
        proc.terminate()
        proc.communicate(timeout=10)


def test_demo_torch_web_needs_a_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --web serves from it")
    out = subprocess.run([sys.executable, "demo_torch.py", "--web", "--port", "0",
                          "--map-size", "16"], cwd=str(ROOT), env=DEMO_ENV,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode != 0 and "needs a CUDA device" in out.stderr
