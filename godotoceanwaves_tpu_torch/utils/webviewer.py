"""Browser viewer: the reference's interactive surface over HTTP.

Counterpart of the JAX package's `utils/webviewer.py`, on PyTorch. Serves the
live simulation as a self-refreshing image plus a parameter panel, the
browser companion of the ANSI `LiveViewer` (utils/live.py). Its capability
target is the reference's interactive scene (C1/C2/C13 + the ImGui panel,
main.gd:57-121): every cascade parameter editable at runtime with immediate
visual feedback, resolution/mesh-quality combos, update-rate control,
FPS/frame-time readout, a mouse-captured fly camera (camera.gd:15-47:
pointer-drag look, WASD/QE moves, wheel speed, shift sprint), and the
32768-particle spray composited into every frame.

Design: a sim thread steps `Ocean`, advances the spray and renders shaded
frames of the DISPLACED clipmap geometry on the ocean's device
(models/viewport.SceneRenderer), fetches each frame through
`FramePipeline` and encodes it under a lock; a stdlib ThreadingHTTPServer
serves
    GET  /           the panel page (vanilla JS, no dependencies)
    GET  /frame.png  the latest rendered frame
    GET  /state      JSON: params per cascade, config, camera, frame stats
    POST /set        {"cascade": i, "name": field, "value": v}, plus
                     map_size / mesh_quality / updates_per_second / spray /
                     water_color / foam_color / num_cascades /
                     camera_look [dx,dy] / camera_move [f,s,r,sprint,dt] /
                     camera_speed clicks
The camera pose and the colours reach the renderer as host numbers, which
become device fills (no host-to-device copy a frame). Edits run over the
same `Ocean.set_cascade` dirty-bit API the reference's setters map to.

Frames go out as JPEG where PIL with JPEG support imports, else as a PNG
written with the standard library (`png_bytes`), so the viewer serves on a
machine without PIL. Every device object the viewer creates lives on
`ocean.device`; the sim thread and the reconfiguration worker both launch on
the default stream, so their work serializes on the card.

Usage: `python demo_torch.py --web [--port 8000]`, then open
http://localhost:8000.
"""
from __future__ import annotations

import dataclasses
import functools
import io
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models.camera import FlyCamera
from ..models.viewport import (RENDER_TIERS, FramePipeline, SceneRenderer, SpraySession,
                               make_batched_step, ycbcr_to_rgb, yuv420_to_ycbcr)
from .live import PARAM_STEPS, RESOLUTIONS
from .observability import FrameStats

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# The standard-library PNG's zlib level and row filter, chosen from
# chip_smoke.py phase 19's sweep on real frames (PERF.md §5 "Web viewer"):
# level 1 is the fastest level that compresses (level 0 sends 2.7x the
# bytes); filter 2 ("up") keeps filter 0's time (within 6 % at 640x360,
# 5-12 % faster at 1280x720) for 2-20 % fewer bytes; levels 3-9 cost
# 1.4-15x its time for 5-18 % fewer bytes.
PNG_LEVEL = 1
PNG_FILTER = 2


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def png_bytes(rgb: np.ndarray, level: int = PNG_LEVEL, row_filter: int = PNG_FILTER) -> bytes:
    """(H, W, 3) uint8 RGB as a PNG (colour type 2, 8 bits): one IDAT of
    the rows, each led by its filter byte, 0 (none) or 2 ("up": each byte
    less the byte above it, modulo 256), deflated by `zlib` at `level`."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"png_bytes takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    if row_filter not in (0, 2):
        raise ValueError(f"row_filter must be 0 or 2, got {row_filter!r}")
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3)
    raw = np.empty((h, w * 3 + 1), np.uint8)
    raw[:, 0] = row_filter
    raw[:, 1:] = rows
    if row_filter == 2:
        np.subtract(rows[1:], rows[:-1], out=raw[1:, 1:])   # uint8: wraps modulo 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


@functools.lru_cache(maxsize=None)
def jpeg_available() -> bool:
    """True where PIL imports and its build writes JPEG."""
    try:
        from PIL import Image
    except ImportError:
        return False
    try:
        Image.new("RGB", (8, 8)).save(io.BytesIO(), format="JPEG")
    except (OSError, KeyError):      # no JPEG encoder in this PIL build
        return False
    return True


def _frame_bytes(arr: np.ndarray, mode: str = "RGB",
                 encoder: str = "auto") -> tuple[bytes, str]:
    """Encode a frame for the wire -> (body, MIME type).

    ``encoder="auto"`` writes JPEG q85 where `jpeg_available()`, else a PNG
    with the standard library; ``"jpeg"`` or ``"png"`` forces one.
    ``mode="YCbCr"`` takes the device-subsampled YUV frame: straight into
    the JPEG encoder (its native colour space), converted to RGB for the
    PNG. A frame that does not encode raises."""
    if mode not in ("RGB", "YCbCr"):
        raise ValueError(f"unknown frame mode {mode!r}")
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"a frame is (H, W, 3) uint8, got {arr.dtype} {arr.shape}")
    if encoder == "auto":
        encoder = "jpeg" if jpeg_available() else "png"
    if encoder == "jpeg":
        from PIL import Image
        buf = io.BytesIO()
        Image.frombytes(mode, (arr.shape[1], arr.shape[0]), arr.tobytes()).save(
            buf, format="JPEG", quality=85)
        return buf.getvalue(), "image/jpeg"
    if encoder != "png":
        raise ValueError(f"unknown encoder {encoder!r}")
    if mode == "YCbCr":
        arr = ycbcr_to_rgb(arr)
    return png_bytes(arr), "image/png"


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>godotoceanwaves_tpu</title>
<style>
 body { font: 13px system-ui, sans-serif; background: #10141a; color: #cdd6e4;
        display: flex; gap: 16px; margin: 16px; }
 #view img { width: 100%%; border-radius: 6px; display: block; cursor: grab;
             user-select: none; -webkit-user-drag: none; }
 #view img.dragging { cursor: grabbing; }
 #view { flex: 1; min-width: 0; }
 #panel { width: 300px; flex: none; }
 .row { display: flex; align-items: center; gap: 6px; margin: 3px 0; }
 .row label { flex: 1; }
 .row input[type=range] { flex: 2; }
 .val { width: 56px; text-align: right; font-variant-numeric: tabular-nums; }
 select, button { background: #1c2430; color: inherit; border: 1px solid #334;
                  border-radius: 4px; padding: 2px 6px; }
 #stats { margin-top: 8px; color: #8aa; white-space: pre; }
 #help { margin-top: 6px; color: #678; font-size: 11px; }
 h3 { margin: 4px 0 8px; }
</style></head><body>
<div id="view"><img id="frame" src="/frame.png" draggable="false">
 <div id="help">drag to look &middot; WASD move &middot; Q/E down/up &middot;
  shift sprint &middot; wheel speed &middot; ctrl-H panel &middot;
  ctrl-F fullscreen</div></div>
<div id="panel">
 <h3>ocean panel</h3>
 <div class="row"><label>cascade</label><select id="cascade"></select></div>
 <div id="params"></div>
 <div class="row"><label>cascades</label>
   <button id="subcasc">-</button><span class="val" id="ncasc"></span>
   <button id="addcasc">+</button></div>
 <div class="row"><label>water color</label><input id="wcolor" type="color"></div>
 <div class="row"><label>foam color</label><input id="fcolor" type="color"></div>
 <div class="row"><label>map size</label><select id="mapsize"></select></div>
 <div class="row"><label>mesh quality</label><select id="meshq">
   <option>low</option><option>high</option></select></div>
 <div class="row"><label>render tier</label><select id="rtier">
   <option>quality</option><option>interactive</option>
   <option>performance</option></select></div>
 <div class="row"><label>render scale</label><select id="rscale"></select></div>
 <div class="row"><label>frame batch</label><select id="fbatch">
   <option>1</option><option>2</option><option>3</option>
   <option>4</option><option>5</option><option>6</option>
   <option>7</option><option>8</option></select></div>
 <div class="row"><label>spray</label><input id="spray" type="checkbox"></div>
 <div class="row"><label>specular AA</label>
   <input id="specaa" type="checkbox"></div>
 <div class="row"><label>updates/s</label>
   <input id="ups" type="range" min="0" max="60" step="1">
   <span class="val" id="upsv"></span></div>
 <div class="row"><label>fov</label>
   <input id="fov" type="range" min="20" max="170" step="1">
   <span class="val" id="fovv"></span></div>
 <div class="row"><label>ambience</label><button id="audio">play</button></div>
 <div id="stats"></div>
</div>
<audio id="aud_o" src="/ambience/ocean.wav" loop preload="none"></audio>
<audio id="aud_w" src="/ambience/wind.wav" loop preload="none"></audio>
<script>
const RANGES = %(ranges)s;
let state = null, cascade = 0;
const el = id => document.getElementById(id);

async function post(body, refresh = true) {
  await fetch('/set', {method: 'POST', body: JSON.stringify(body)});
  if (refresh) await refreshState();
}
function slider(name, value) {
  const [lo, hi, step] = RANGES[name];
  const row = document.createElement('div'); row.className = 'row';
  row.innerHTML = `<label>${name}</label>
    <input type="range" min="${lo}" max="${hi}" step="${step}" value="${value}">
    <span class="val">${Number(value).toFixed(2)}</span>`;
  const inp = row.querySelector('input');
  inp.oninput = () => { row.querySelector('.val').textContent =
                        Number(inp.value).toFixed(2); };
  inp.onchange = () => post({cascade, name, value: Number(inp.value)});
  return row;
}
function rebuildParams() {
  const box = el('params'); box.innerHTML = '';
  const p = state.cascades[cascade];
  for (const name in RANGES) box.appendChild(slider(name, p[name]));
}
async function refreshState() {
  state = await (await fetch('/state')).json();
  if (state.warming) { el('stats').textContent = 'warming up (first compile)...'; return; }
  const sel = el('cascade');
  if (sel.options.length !== state.cascades.length) {
    sel.innerHTML = state.cascades.map((_, i) => `<option>${i}</option>`).join('');
  }
  sel.value = cascade;
  const ms = el('mapsize');
  if (!ms.options.length) {
    ms.innerHTML = state.resolutions.map(r => `<option>${r}</option>`).join('');
    ms.onchange = () => post({name: 'map_size', value: Number(ms.value)});
  }
  ms.value = state.map_size;
  el('meshq').value = state.mesh_quality;
  if (document.activeElement !== el('rtier')) el('rtier').value = state.render_tier;
  const rs = el('rscale');
  if (!rs.options.length) {
    rs.innerHTML = state.render_scales.map(s => `<option>1/${s}</option>`).join('');
    rs.onchange = () => post({name: 'render_scale',
                              value: Number(rs.value.slice(2))});
  }
  if (document.activeElement !== rs) rs.value = '1/' + state.render_scale;
  if (document.activeElement !== el('fbatch'))
    el('fbatch').value = state.frame_batch;
  el('spray').checked = state.spray;
  el('specaa').checked = state.specular_aa;
  el('ncasc').textContent = state.cascades.length;
  if (document.activeElement !== el('wcolor')) el('wcolor').value = hex(state.water_color);
  if (document.activeElement !== el('fcolor')) el('fcolor').value = hex(state.foam_color);
  if (cascade >= state.cascades.length) cascade = 0;
  el('ups').value = state.updates_per_second;
  el('upsv').textContent = state.updates_per_second;
  if (document.activeElement !== el('fov')) el('fov').value = state.fov;
  el('fovv').textContent = Number(state.fov).toFixed(0);
  el('stats').textContent =
    `sim ${state.fps.toFixed(1)} fps  ${state.ms_frame.toFixed(1)} ms/frame\\n` +
    `frame ${state.frame}  cam [${state.camera.map(v => v.toFixed(1))}]  ` +
    `pitch ${state.camera_pitch.toFixed(1)}  yaw ${state.camera_yaw.toFixed(1)}  ` +
    `speed ${state.camera_speed.toFixed(1)}`;
  rebuildParams();
  applyAudioGains();
}
el('cascade').onchange = e => { cascade = Number(e.target.value); rebuildParams(); };
function hex(rgb) {  // linear [0,1] -> sRGB #rrggbb
  return '#' + rgb.map(v => Math.round(Math.pow(v, 1/2.2) * 255)
    .toString(16).padStart(2, '0')).join('');
}
function rgb(hexstr) {  // #rrggbb -> sRGB [0,1]
  return [1, 3, 5].map(i => parseInt(hexstr.slice(i, i + 2), 16) / 255);
}
el('wcolor').onchange = e => post({name: 'water_color', value: rgb(e.target.value)});
el('fcolor').onchange = e => post({name: 'foam_color', value: rgb(e.target.value)});
el('meshq').onchange = e => post({name: 'mesh_quality', value: e.target.value});
el('rtier').onchange = e => post({name: 'render_tier', value: e.target.value});
el('fbatch').onchange = e => post({name: 'frame_batch',
                                   value: Number(e.target.value)});
el('spray').onchange = e => post({name: 'spray', value: e.target.checked});
el('specaa').onchange = e => post({name: 'specular_aa',
                                   value: e.target.checked});
el('addcasc').onclick = () => post({name: 'num_cascades',
                                    value: state.cascades.length + 1});
el('subcasc').onclick = () => { cascade = 0;
  post({name: 'num_cascades', value: state.cascades.length - 1}); };
el('ups').onchange = e => post({name: 'updates_per_second',
                                value: Number(e.target.value)});
el('fov').oninput = e => { el('fovv').textContent = e.target.value; };
el('fov').onchange = e => post({name: 'fov', value: Number(e.target.value)});

// --- ambience (main.gd:39-44 over HTTP) ---
// seamless procedural loops served by the session; volumes follow the
// reference's wind-speed dB law, BOTH stems shifted by the same -15 dB
// (the law's maximum) so the loudest stem sits at volume 1.0 and the
// ocean:wind BALANCE stays exactly the reference's (a per-stem shift
// would skew it; audio.render_ambience normalizes the same way)
let audioOn = false;
function applyAudioGains() {
  if (!state || !state.ambience_db) return;
  el('aud_o').volume = Math.min(1, Math.pow(10, (state.ambience_db[0] - 15) / 20));
  el('aud_w').volume = Math.min(1, Math.pow(10, (state.ambience_db[1] - 15) / 20));
}
el('audio').onclick = () => {
  audioOn = !audioOn;
  el('audio').textContent = audioOn ? 'stop' : 'play';
  for (const id of ['aud_o', 'aud_w']) {
    if (audioOn) el(id).play(); else el(id).pause();
  }
  applyAudioGains();
};

// --- fly camera (camera.gd:15-47 over HTTP) ---
const frame = el('frame');
let dragging = false, accX = 0, accY = 0;
frame.onpointerdown = e => { dragging = true; frame.classList.add('dragging');
                             frame.setPointerCapture(e.pointerId); };
frame.onpointerup = e => { dragging = false; frame.classList.remove('dragging'); };
frame.onpointermove = e => { if (dragging) { accX += e.movementX; accY += e.movementY; } };
setInterval(() => {
  if (accX || accY) { post({name: 'camera_look', value: [accX, accY]}, false);
                      accX = 0; accY = 0; }
}, 60);
frame.onwheel = e => { e.preventDefault();
  post({name: 'camera_speed', value: e.deltaY < 0 ? 1 : -1}, false); };
// UI/fullscreen toggles (main.gd:46-53; input map project.godot:45-54:
// Ctrl-H = panel, Ctrl-F = fullscreen, Esc = windowed — the browser
// handles Esc natively)
addEventListener('keydown', e => {
  if (!(e.ctrlKey || e.metaKey)) return;
  const k = e.key.toLowerCase();
  if (k === 'h') {
    e.preventDefault();
    const p = el('panel');
    p.style.display = p.style.display === 'none' ? '' : 'none';
  } else if (k === 'f') {
    e.preventDefault();
    if (document.fullscreenElement) document.exitFullscreen();
    else el('view').requestFullscreen();
  }
});
const keys = new Set();
addEventListener('keydown', e => {
  if (e.target.tagName === 'INPUT' || e.target.tagName === 'SELECT') return;
  keys.add(e.key.toLowerCase()); });
addEventListener('keyup', e => keys.delete(e.key.toLowerCase()));
setInterval(() => {
  const f = (keys.has('w') ? 1 : 0) - (keys.has('s') ? 1 : 0);
  const s = (keys.has('d') ? 1 : 0) - (keys.has('a') ? 1 : 0);
  const r = (keys.has('e') ? 1 : 0) - (keys.has('q') ? 1 : 0);
  if (f || s || r) post({name: 'camera_move',
    value: [f, s, r, keys.has('shift') ? 1 : 0, 0.09]}, false);
}, 90);

async function frameLoop() {
  let prevUrl = null;
  for (;;) {
    try {
      const blob = await (await fetch('/frame.png?' + Date.now())).blob();
      const url = URL.createObjectURL(blob);
      el('frame').src = url;
      if (prevUrl) URL.revokeObjectURL(prevUrl);  // don't leak blobs
      prevUrl = url;
    } catch (e) {}
    await new Promise(r => setTimeout(r, 1000 / %(fps)d));
  }
}
refreshState(); setInterval(refreshState, 2000); frameLoop();
</script></body></html>"""

# slider (lo, hi, step) per editable field: the ImGui panel's widget ranges
PARAM_RANGES: dict[str, tuple[float, float, float]] = {
    "wind_speed": (0.0, 60.0, 0.5),
    "wind_direction": (-180.0, 180.0, 1.0),
    "fetch_length": (1.0, 1000.0, 1.0),
    "swell": (0.0, 2.0, 0.05),
    "spread": (0.0, 1.0, 0.01),
    "detail": (0.0, 1.0, 0.01),
    "whitecap": (0.0, 2.0, 0.05),
    "foam_amount": (0.0, 10.0, 0.1),
    "tile_length": (2.0, 2048.0, 1.0),
    "displacement_scale": (0.0, 2.0, 0.05),
    "normal_scale": (0.0, 2.0, 0.05),
}
assert set(PARAM_RANGES) == set(PARAM_STEPS)  # same surface as the ANSI viewer


def _valid_frame_batch(value) -> bool:
    return isinstance(value, int) and not isinstance(value, bool) and 1 <= value <= 8


class WebViewer:
    """Serve `ocean` interactively; `start()`/`stop()` for embedding/tests,
    `run()` to block. Runs on `ocean.device`."""

    def __init__(self, ocean, fps: float = 20.0, width: int = 640,
                 height: int = 360, environment: bool = True,
                 mesh_quality: str = "low", flat: bool = False,
                 spray: bool = False, spray_particles: int = 32768,
                 transfer: str = "auto", render_tier: str = "interactive",
                 render_scale: int = 1, frame_batch: int = 1,
                 specular_aa: bool = False):
        from ..models.ocean import require_one_size
        require_one_size(ocean, "WebViewer")
        self.ocean = ocean
        # K-frame batching (models/viewport.make_batched_step): one call
        # advances K sim ticks and renders all K frames. Active only when
        # updates_per_second == 0 and stagger is off (every tick steps, so K
        # ticks batch losslessly); otherwise the loop runs single frames.
        # Pose/parameter edits apply at batch granularity (~K/fps s latency).
        if not _valid_frame_batch(frame_batch):
            raise ValueError(f"frame_batch must be an int in [1, 8], "
                             f"got {frame_batch!r}")
        self.frame_batch = frame_batch
        self._batched = None   # (key, batched step, spray_params) cache
        self._batch_pending_k = None   # K of batch_pipeline's pending batch
        self.environment = environment
        self.fps = fps
        self.width = width
        self.height = height
        self.flat = flat
        # dynamic resolution (geometry.render_ocean_geometry render_scale):
        # march/shade at 1/s and upsample on the device. Ignored on the flat
        # path. Editable live from the panel combo (same async warm+swap as
        # a tier change); the combo offers only divisors of this viewer's
        # fixed output size.
        self._valid_render_scales = [1] if flat else [
            s for s in (1, 2, 3, 4)
            if s == 1 or (width % s == 0 and height % s == 0)]
        # the constructor accepts exactly what the panel combo offers, so
        # /state's reported scale always matches what actually renders
        if render_scale not in self._valid_render_scales:
            raise ValueError(
                f"render_scale={render_scale} not in "
                f"{self._valid_render_scales} for "
                f"{width}x{height} (flat={flat})")
        self.render_scale = render_scale
        # screen-space specular AA (shading.shade specular_aa, not in the
        # reference): edited live through the same async warm+swap worker
        # as a tier change. The geometry path only.
        if specular_aa and flat:
            raise ValueError("specular_aa needs the geometry render path "
                             "(flat=False)")
        self.specular_aa = bool(specular_aa)
        if transfer not in ("auto", "rgb", "yuv420"):
            raise ValueError(f"unknown transfer {transfer!r}")
        self.transfer = transfer
        self.stats = FrameStats()
        # the reference's fly camera (camera.gd)
        self.camera = FlyCamera()
        self.mesh_quality = mesh_quality
        if render_tier not in RENDER_TIERS:
            raise ValueError(f"unknown render_tier {render_tier!r}")
        self.render_tier = render_tier
        # spray system (C13, main.tscn:133-140): persistent state advanced
        # in the sim thread; the session survives renderer rebuilds
        self.spray_enabled = spray
        self._spray = SpraySession(num_particles=spray_particles, device=ocean.device)
        # Three locks so the panel stays responsive while device work runs:
        # _ocean_lock serializes Ocean access (sim step vs /set edits);
        # _cam_lock guards the host-side camera/toggles (instant edits that
        # must not wait on a device step); _frame_lock guards only the
        # encoded-frame/state-cache swap.
        self._ocean_lock = threading.Lock()
        self._cam_lock = threading.Lock()
        self._frame_lock = threading.Lock()
        # ambience loops (C20): synthesized once on first request
        self._audio_lock = threading.Lock()
        self._ambience: dict[str, bytes] = {}
        self._png, self._mime = _frame_bytes(
            np.zeros((height, width, 3), np.uint8))
        self._frame_no = 0
        self._state_cache: dict | None = None
        # Warming stub served while the sim thread holds _ocean_lock through
        # its first frame (on the card, the first-use nvcc build of the
        # kernels, ops/_build.py): snapshotted HERE, before any thread
        # exists, so _state never reads ocean host attributes unlocked.
        self._warming_stub = {
            "warming": True,
            "cascades": [],
            "map_size": ocean.config.map_size,
            "resolutions": list(RESOLUTIONS),
            "updates_per_second": ocean.updates_per_second,
            "water_color": [float(v) for v in ocean.water_color],
            "foam_color": [float(v) for v in ocean.foam_color],
        }
        self._stop = threading.Event()
        self._server: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []
        # async reconfiguration state (guarded by _cam_lock): a resize or a
        # renderer rebuild runs the new configuration once on throwaway
        # state in a background worker while old frames keep serving, then
        # swaps under _ocean_lock (the reference's combo swaps live,
        # main.gd:66-70).
        self._resizing = False
        self._retiering = False
        # ONE reconfiguration worker serializes every warm+swap (resize,
        # render tier, scale, AA): a tier renderer warmed against a
        # pre-resize map size would be stale. Pending edits collapse to the
        # latest per kind.
        self._reconf_busy = False
        self._reconf_pending: dict = {}
        self._build_renderers()

    def _build_renderers(self) -> None:
        """The render path (models/viewport.SceneRenderer, shared with the
        ANSI viewer and demo_torch.py): the pose, colours and spray
        attributes are call arguments; gamma and uint8 quantization happen
        on the device, so a frame crosses to the host as its bytes."""
        self._viewport = self._build_tier_renderer(self.render_tier)

    def _resolved_transfer(self) -> str:
        """The wire format: transfer="auto" is YUV420 (1.5 B/px on the way
        to the host) where a JPEG encoder takes it as it is and both
        dimensions are even; otherwise RGB, which the PNG path needs
        (YUV420 there would only make the host undo the subsampling every
        frame)."""
        if self.transfer == "auto":
            return ("yuv420"
                    if jpeg_available() and self.width % 2 == 0 and self.height % 2 == 0
                    else "rgb")
        return self.transfer

    # --- camera / host-side edits (instant; _cam_lock) --------------------
    def _apply_camera(self, name: str, value) -> None:
        with self._cam_lock:
            if name == "camera_look":
                dx, dy = float(value[0]), float(value[1])
                self.camera.look(dx, dy)
            elif name == "camera_move":
                f, s, r, sprint, dt = [float(v) for v in value]
                self.camera.move(dt, forward=f, strafe=s, rise=r,
                                 sprint=bool(sprint))
            elif name == "camera_speed":
                self.camera.scroll(int(value))
            elif name == "fov":
                # the reference panel's FOV slider range (main.gd:113-114)
                self.camera.fov_deg = float(np.clip(float(value),
                                                    20.0, 170.0))
            elif name == "spray":
                self.spray_enabled = bool(value)
            else:
                raise KeyError(name)

    def _camera_args(self):
        """Pose render args: the position as an fp32 NumPy array, pitch,
        yaw and fov as fp32-rounded Python floats. The renderer turns them
        into device fills, not host-to-device copies."""
        with self._cam_lock:
            pos = np.asarray(self.camera.position, np.float32)
            pitch = float(np.float32(np.rad2deg(self.camera.pitch)))
            yaw = float(np.float32(np.rad2deg(self.camera.yaw)))
            fov = float(np.float32(self.camera.fov_deg))
        return pos, pitch, yaw, fov

    # --- simulation/render loop ------------------------------------------
    def _sim_loop(self) -> None:
        dt = 1.0 / self.fps
        maps = None
        # The params snapshot is not rebuilt per frame: it reads the params
        # back to the host, and they change only on /set edits, which
        # refresh the cache themselves.
        with self._ocean_lock:
            snap0 = self._snapshot_ocean()
        with self._frame_lock:
            if self._state_cache is None:
                self._state_cache = snap0
        # pipelined fetch: publish frame N's bytes while frame N+1's device
        # work is in flight (one tick of extra latency)
        pipeline = FramePipeline()        # single-frame path
        batch_pipeline = FramePipeline()  # K-frame path (separate: pending
        #                                   payload shapes differ per mode)
        last_mode = None
        while not self._stop.is_set():
            batched = self._use_batched()
            mode = "batched" if batched else "single"
            if mode != last_mode:
                # a pending frame/batch from the OTHER mode is arbitrarily
                # stale: drop it rather than time-rewind the stream
                pipeline.discard()
                batch_pipeline.discard()
                self._batch_pending_k = None
                last_mode = mode
            if batched:
                self._batched_tick(batch_pipeline, dt)
                continue
            t0 = time.perf_counter()
            with self._ocean_lock:
                maps = self.ocean.update(dt) or maps
                scales = self.ocean.params.map_scales()
                wc = np.asarray(self.ocean.water_color, np.float32)
                fc = np.asarray(self.ocean.foam_color, np.float32)
            if maps is None:           # scheduler skipped the very first tick
                self._stop.wait(dt)
                continue
            pos, pitch, yaw, fov = self._camera_args()
            attrs = (self._spray.advance(maps, scales, dt)
                     if self.spray_enabled else None)
            img = self._viewport.render(maps, scales, wc, fc,
                                        pos, pitch, yaw, fov=fov,
                                        spray_attrs=attrs)
            host = pipeline.push(img)
            if host is not None:
                self._publish(host)
            took = time.perf_counter() - t0
            self.stats.record(took)
            self._stop.wait(max(0.0, dt - took))

    def _publish(self, host: np.ndarray) -> None:
        """Encode + publish one host wire-format frame. Drops frames whose
        size does not match the CURRENT surface (a resize can swap the
        renderer while one old-size frame is still in a pipeline)."""
        if self._viewport.transfer == "yuv420":
            if host.size != self.height * self.width * 3 // 2:
                return
            ycbcr = yuv420_to_ycbcr(host, self.height, self.width)
            png, mime = _frame_bytes(ycbcr, mode="YCbCr")
        else:
            if host.shape[:2] != (self.height, self.width):
                return
            png, mime = _frame_bytes(host)
        with self._frame_lock:
            self._png = png
            self._mime = mime
            self._frame_no += 1

    # --- K-frame batching ---------------------------------------------------
    def _use_batched(self) -> bool:
        return (self.frame_batch > 1
                and self.ocean.updates_per_second == 0
                and not self.ocean.stagger)

    def _batched_step_fn(self, k: int):
        """(Re)build the K-frame step when anything static about it changed:
        renderer swap (resize/tier), sim config (map resize), spray toggle,
        or frame_batch edit. `k` is the caller's once-per-tick read of
        frame_batch: re-reading the live attribute here would race a
        concurrent panel edit (the tick would then advance the clock by a
        DIFFERENT k than the step ran)."""
        spray_params = (self._spray.ensure_init()[0]
                        if self.spray_enabled else None)
        key = (id(self._viewport), self.ocean.config, k, id(spray_params))
        cached = self._batched     # one read: a renderer swap may drop it
        if cached is not None and cached[0] == key:
            return cached[1], cached[2]
        fn = make_batched_step(self._viewport, self.ocean.config,
                               spray_params, k)
        self._batched = (key, fn, spray_params)
        return fn, spray_params

    def _batched_tick(self, pipeline, dt: float) -> None:
        """One loop iteration in batched mode: run K sim+render frames as
        one step, fetch the PREVIOUS batch while it computes, and publish
        those K frames paced at the target rate."""
        k = self.frame_batch      # single read: everything below uses it
        if self._batch_pending_k not in (None, k):
            # the pending batch ran at a different K: its pacing window and
            # stats split no longer match; drop it
            pipeline.discard()
        t0 = time.perf_counter()
        fn, spray_params = self._batched_step_fn(k)
        pos, pitch, yaw, fov = self._camera_args()
        with self._ocean_lock:
            o = self.ocean
            o.regenerate_dirty()
            wc = np.asarray(o.water_color, np.float32)
            fc = np.asarray(o.foam_color, np.float32)
            sp_state = self._spray._state if spray_params is not None else None
            clock = self._spray.clock if spray_params is not None else 0.0
            state, sp_state, frames, last = fn(
                o.state, o.params, sp_state, np.float32(clock), wc, fc,
                pos, pitch, yaw, fov, np.float32(dt))
            o.state = state
            o.maps = last
            o._time += k * dt
            if spray_params is not None:
                self._spray._state = sp_state
                self._spray.clock = clock + k * dt
        host = pipeline.push(frames)
        self._batch_pending_k = k
        work = time.perf_counter() - t0
        if host is not None:
            for i in range(len(host)):
                e0 = time.perf_counter()
                self._publish(host[i])
                work += time.perf_counter() - e0
                if self._stop.is_set():
                    return
                # deadline pacing from tick start: the whole tick targets
                # k*dt wall, absorbing step+fetch time instead of stacking
                # on top of it
                self._stop.wait(
                    max(0.0, t0 + (i + 1) * dt - time.perf_counter()))
        for _ in range(k):
            self.stats.record(work / k)
        self._stop.wait(max(0.0, t0 + k * dt - time.perf_counter()))

    # --- http --------------------------------------------------------------
    def _snapshot_ocean(self) -> dict:
        """Ocean-derived part of /state; call with _ocean_lock held. The
        params come to the host in one tree move, not one read a field."""
        from .hostio import device_get_tree
        p = device_get_tree(self.ocean.params)
        cascades = []
        for i in range(self.ocean.params.num_cascades):
            row = {}
            for name in PARAM_RANGES:
                v = getattr(p, name)[i].numpy()
                row[name] = float(v[0]) if v.ndim else float(v)
            cascades.append(row)
        return {
            "cascades": cascades,
            "map_size": self.ocean.config.map_size,
            "resolutions": list(RESOLUTIONS),
            "updates_per_second": self.ocean.updates_per_second,
            "water_color": [float(v) for v in self.ocean.water_color],
            "foam_color": [float(v) for v in self.ocean.foam_color],
        }

    def _state(self) -> dict:
        # Served from the cache refreshed by the sim thread / _apply so a
        # long device step (first-use kernel build, resize) never blocks the
        # panel.
        with self._frame_lock:
            snap = self._state_cache
            frame_no = self._frame_no
        if snap is None:
            # Cold start: the sim thread may hold _ocean_lock through the
            # first frame; never block the panel (or a probe's short HTTP
            # timeout) behind it. Bounded wait, then a host-only warming stub.
            if self._ocean_lock.acquire(timeout=2.0):
                try:
                    snap = self._snapshot_ocean()
                finally:
                    self._ocean_lock.release()
                with self._frame_lock:
                    if self._state_cache is None:
                        self._state_cache = snap
            else:
                snap = self._warming_stub
        s = self.stats.summary()
        with self._cam_lock:
            cam = [float(v) for v in self.camera.position]
            speed = float(self.camera.speed)
            fov = float(self.camera.fov_deg)
            pitch = float(np.rad2deg(self.camera.pitch))
            yaw = float(np.rad2deg(self.camera.yaw))
            spray_on = self.spray_enabled
            resizing = self._resizing
            retiering = self._retiering
        # ambience mix law from the live stack (main.gd:39-44): total wind
        # speed from the cached snapshot, no device interaction
        from .audio import ambience_gains_db
        total_wind = sum(c["wind_speed"] for c in snap["cascades"])
        return {**snap, "fps": s["fps"], "ms_frame": s["ms_mean"],
                "frame": frame_no, "camera": cam, "camera_speed": speed,
                "fov": fov, "camera_pitch": pitch, "camera_yaw": yaw,
                "spray": spray_on, "mesh_quality": self.mesh_quality,
                "resizing": resizing, "render_tier": self.render_tier,
                "retiering": retiering, "render_scale": self.render_scale,
                "render_scales": self._valid_render_scales,
                "frame_batch": self.frame_batch,
                "specular_aa": self.specular_aa,
                "ambience_db": list(ambience_gains_db(total_wind))}

    def _apply(self, req: dict) -> None:
        name = req["name"]
        value = req["value"]
        if name in ("camera_look", "camera_move", "camera_speed", "spray",
                    "fov"):
            self._apply_camera(name, value)
            return
        if name == "map_size":
            # async: warm the new size in the background, then swap
            self._resize_async(int(value))
            return
        if name == "render_tier":
            self._retier_async(str(value))
            return
        if name == "render_scale":
            self._rescale_async(int(value))
            return
        if name == "frame_batch":
            # a host-side int the sim loop reads each iteration; the K > 1
            # step is (re)built lazily in the loop. Same check as the
            # constructor (2.7 must not truncate to 2).
            if not _valid_frame_batch(value):
                raise KeyError(value)
            self.frame_batch = value
            return
        if name == "specular_aa":
            # a shade kwarg: rebuilt through the async worker like a tier
            # change (flat has no shade path)
            if self.flat:
                raise KeyError(name)
            self._reconfigure_async("specular_aa", bool(value))
            return
        with self._ocean_lock:
            if name == "mesh_quality":
                if value not in ("low", "high"):
                    raise KeyError(value)
                self.mesh_quality = value
                self._build_renderers()
            elif name in ("water_color", "foam_color"):
                # page sends sRGB [r,g,b] in [0,1]; shade() wants linear
                # (the reference converts too: water.gd srgb_to_linear)
                lin = np.clip(np.asarray(value, np.float32), 0, 1) ** 2.2
                setattr(self.ocean, name, lin)
            elif name == "num_cascades":
                from ..models.cascade import CascadeParams
                want = max(1, min(8, int(value)))
                have = self.ocean.num_cascades
                p = self.ocean.params
                stacks = [p.map(lambda x, i=i: x[i])
                          for i in range(min(want, have))]
                while len(stacks) < want:      # append defaults (inspector add)
                    stacks.append(CascadeParams.create(device=self.ocean.device))
                self.ocean.set_cascades(stacks)
            elif name == "updates_per_second":
                self.ocean.updates_per_second = float(value)
            elif name in PARAM_RANGES:
                self.ocean.set_cascade(int(req.get("cascade", 0)),
                                       **{name: float(value)})
            else:
                raise KeyError(name)
            snap = self._snapshot_ocean()
        with self._frame_lock:
            self._state_cache = snap

    # --- async reconfiguration (the ImGui resolution combo swaps live,
    # main.gd:66-70) ------------------------------------------------------------
    def _resize_async(self, new_size: int) -> None:
        """Warm the new map size in the background worker, then swap.
        Old-size frames keep serving throughout; rapid clicks collapse to
        the latest request. Shares ONE worker with the renderer swaps, so a
        tier renderer is never warmed against a pre-resize map size."""
        self._reconfigure_async("map_size", int(new_size))

    def _reconfigure_async(self, name: str, value) -> None:
        with self._cam_lock:
            self._reconf_pending[name] = value
            if name == "map_size":
                self._resizing = True
            else:
                self._retiering = True
            if self._reconf_busy:
                return
            self._reconf_busy = True
        threading.Thread(target=self._reconf_worker, daemon=True).start()

    def _reconf_worker(self) -> None:
        """Single serializer for every warm+swap reconfiguration. Pops the
        LATEST pending map_size/render_tier/scale/AA each pass (rapid clicks
        collapse), warms with no lock held, swaps, repeats until no edits
        remain, so a tier warm always sees the post-resize config and vice
        versa."""
        try:
            while True:
                with self._cam_lock:
                    if not self._reconf_pending:
                        self._reconf_busy = False
                        self._resizing = False
                        self._retiering = False
                        return
                    want_size = self._reconf_pending.pop("map_size", None)
                    want_tier = self._reconf_pending.pop("render_tier", None)
                    want_scale = self._reconf_pending.pop("render_scale",
                                                          None)
                    want_aa = self._reconf_pending.pop("specular_aa", None)
                scale_requested = want_scale is not None
                aa_requested = want_aa is not None
                if want_scale == self.render_scale:
                    want_scale = None           # scale == current: no-op
                if want_aa == self.specular_aa:
                    want_aa = None              # aa == current: no-op
                tier_changed = (want_tier is not None
                                and want_tier != self.render_tier)
                rebuild = (tier_changed or want_scale is not None
                           or want_aa is not None)
                if want_size is not None and rebuild:
                    self._warm_size_and_tier(
                        want_size, want_tier or self.render_tier,
                        scale=want_scale, aa=want_aa)
                elif want_size is not None:
                    self._warm_one_size(want_size)
                    if want_tier is not None:   # tier == current: no-op swap
                        self.render_tier = want_tier
                elif rebuild:
                    self._warm_one_tier(want_tier or self.render_tier,
                                        scale=want_scale, aa=want_aa)
                elif want_tier is not None:     # tier == current: no-op swap
                    self.render_tier = want_tier
                with self._cam_lock:
                    if want_size is not None \
                            and "map_size" not in self._reconf_pending:
                        self._resizing = False
                    if (want_tier is not None or scale_requested
                            or aa_requested) \
                            and "render_tier" not in self._reconf_pending \
                            and "render_scale" not in self._reconf_pending \
                            and "specular_aa" not in self._reconf_pending:
                        self._retiering = False
        except Exception:       # the worker must not die silently holding the flags
            import traceback
            traceback.print_exc()
            with self._cam_lock:
                self._reconf_busy = False
                self._reconf_pending.clear()
                self._resizing = False
                self._retiering = False

    def _warm_frame(self, viewport: SceneRenderer, map_size: int) -> None:
        """Run `map_size`'s step and `viewport`'s frame once on throwaway
        state (no lock held: frames keep flowing), ending in a fetch. On the
        card this captures the renderer's graph for the new shapes
        (`utils/graphs.py`), and builds the per-(N, device) FFT tables and
        the geometry caches, all of which the first real frame would
        otherwise do inside the serving loop. A throwaway spray session, so
        warming does not advance the live particles' respawn cycles."""
        from ..models.ocean import init_state, step
        cfg = dataclasses.replace(self.ocean.config, map_size=map_size)
        params = self.ocean.params
        state = init_state(cfg, params)
        state, maps = step(cfg, state, params, 1.0 / self.fps)
        scales = params.map_scales()
        wc = np.asarray(self.ocean.water_color, np.float32)
        fc = np.asarray(self.ocean.foam_color, np.float32)
        pos, pitch, yaw, fov = self._camera_args()
        attrs = (SpraySession(self._spray._num_particles, device=self.ocean.device)
                 .advance(maps, scales, 1.0 / self.fps)
                 if self.spray_enabled else None)
        viewport.render(maps, scales, wc, fc, pos, pitch, yaw, fov=fov,
                        spray_attrs=attrs).cpu()

    def _warm_one_size(self, new_size: int) -> None:
        """Warm `new_size` with the live renderer, then swap the live ocean
        under the lock."""
        self._warm_frame(self._viewport, new_size)
        with self._ocean_lock:
            self.ocean.resize(new_size, clear_jit_caches=False)
            snap = self._snapshot_ocean()
        with self._frame_lock:
            self._state_cache = snap

    def _retier_async(self, tier: str) -> None:
        if tier not in RENDER_TIERS:
            raise KeyError(tier)
        self._reconfigure_async("render_tier", str(tier))

    def _rescale_async(self, scale: int) -> None:
        """Panel render-scale combo (dynamic resolution): validate against
        this viewer's fixed output size, then hand to the reconfiguration
        worker."""
        if scale not in self._valid_render_scales:
            raise ValueError(
                f"render_scale={scale} not in {self._valid_render_scales} "
                f"for {self.width}x{self.height}")
        self._reconfigure_async("render_scale", int(scale))

    def _warm_size_and_tier(self, new_size: int, tier: str,
                            scale: int | None = None,
                            aa: bool | None = None) -> None:
        """Combined warm for a size+tier(+scale/aa) group requested
        together: one new renderer warmed at the new size, one atomic swap
        of all."""
        vp = self._build_tier_renderer(tier, scale, aa)
        self._warm_frame(vp, new_size)
        with self._ocean_lock:
            self.ocean.resize(new_size, clear_jit_caches=False)
            self._swap_renderer(vp, tier, scale, aa)
            snap = self._snapshot_ocean()
        with self._frame_lock:
            self._state_cache = snap

    def _scale_kw(self, scale: int | None = None) -> dict:
        s = self.render_scale if scale is None else scale
        return ({"render_scale": s} if s > 1 and not self.flat else {})

    def _aa_kw(self, aa: bool | None = None) -> dict:
        a = self.specular_aa if aa is None else aa
        return ({"specular_aa": True} if a and not self.flat else {})

    def _build_tier_renderer(self, tier: str, scale: int | None = None,
                             aa: bool | None = None) -> SceneRenderer:
        return SceneRenderer(self.width, self.height, flat=self.flat,
                             mesh_quality=self.mesh_quality,
                             environment=self.environment,
                             transfer=self._resolved_transfer(),
                             **self._scale_kw(scale), **self._aa_kw(aa),
                             **RENDER_TIERS[tier])

    def _swap_renderer(self, vp: SceneRenderer, tier: str, scale: int | None,
                       aa: bool | None) -> None:
        """Make `vp` the live renderer; call with _ocean_lock held. The old
        renderer's graphs and memory pool go with it: the K-frame step that
        holds it is dropped too."""
        self._viewport = vp         # atomic swap; next sim tick uses it
        self._batched = None
        self.render_tier = tier
        if scale is not None:
            self.render_scale = scale
        if aa is not None:
            self.specular_aa = aa

    def _warm_one_tier(self, tier: str, scale: int | None = None,
                       aa: bool | None = None) -> None:
        """Build and warm the new tier's renderer on throwaway state (no
        lock held: frames keep flowing), then swap the live renderer.
        `scale` (dynamic resolution) and `aa` (specular AA) rebuild even
        when `tier` is current."""
        if tier == self.render_tier and scale is None and aa is None:
            return
        vp = self._build_tier_renderer(tier, scale, aa)
        self._warm_frame(vp, self.ocean.config.map_size)
        with self._ocean_lock:
            self._swap_renderer(vp, tier, scale, aa)

    def _ambience_wav(self, which: str) -> bytes:
        """Seamless procedural loop bytes (utils/audio synthesis), cached:
        the browser's <audio loop> replaces the reference's wav assets."""
        with self._audio_lock:
            if which not in self._ambience:
                from . import audio
                synth = {"ocean": audio.synthesize_ocean_loop,
                         "wind": audio.synthesize_wind_loop}[which]
                self._ambience[which] = audio.wav_bytes(synth())
            return self._ambience[which]

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    page = _PAGE % {
                        "ranges": json.dumps(PARAM_RANGES),
                        "fps": int(viewer.fps),
                    }
                    self._send(200, "text/html", page.encode())
                elif path == "/frame.png":   # name kept; body may be JPEG
                    with viewer._frame_lock:
                        png, mime = viewer._png, viewer._mime
                    self._send(200, mime, png)
                elif path == "/state":
                    self._send(200, "application/json",
                               json.dumps(viewer._state()).encode())
                elif path in ("/ambience/ocean.wav", "/ambience/wind.wav"):
                    which = path.rsplit("/", 1)[1].split(".")[0]
                    self._send(200, "audio/wav", viewer._ambience_wav(which))
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/set":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    viewer._apply(json.loads(self.rfile.read(n)))
                    self._send(200, "application/json", b"{\"ok\": true}")
                except Exception as e:  # bad field/value -> client error
                    self._send(400, "text/plain", str(e).encode())

        return Handler

    # --- session snapshot ----------------------------------------------------
    def checkpoint(self) -> dict:
        """Full viewer-session snapshot: ocean state (`Ocean.checkpoint`),
        the spray particle state machine (its respawn cycles resume instead
        of restarting), and the camera pose."""
        with self._ocean_lock:
            ocean = self.ocean.checkpoint()
        with self._cam_lock:
            cam = {
                "position": [float(v) for v in self.camera.position],
                "pitch": float(self.camera.pitch),
                "yaw": float(self.camera.yaw),
                "fov_deg": float(self.camera.fov_deg),
                "speed": float(self.camera.speed),
            }
            spray_on = self.spray_enabled
        return {"ocean": ocean, "spray": self._spray.checkpoint(),
                "camera": cam, "spray_enabled": spray_on}

    def restore(self, snapshot: dict) -> None:
        """Restore a `checkpoint()` snapshot into this session."""
        with self._ocean_lock:
            self.ocean.restore(snapshot["ocean"])
            self._spray.restore(snapshot.get("spray"))
            snap = self._snapshot_ocean()
        with self._cam_lock:
            cam = snapshot.get("camera", {})
            if cam:
                self.camera.position = np.asarray(cam["position"],
                                                  np.float32)
                self.camera.pitch = float(cam["pitch"])
                self.camera.yaw = float(cam["yaw"])
                self.camera.fov_deg = float(cam.get("fov_deg", 70.0))
                self.camera.speed = float(cam.get("speed",
                                                  self.camera.speed))
            self.spray_enabled = bool(snapshot.get("spray_enabled",
                                                   self.spray_enabled))
        with self._frame_lock:
            self._state_cache = snap

    # --- lifecycle ---------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 8000) -> int:
        """Start sim + server threads; returns the bound port (0 = ephemeral)."""
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._threads = [
            threading.Thread(target=self._sim_loop, daemon=True),
            threading.Thread(target=self._server.serve_forever, daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self._server.server_address[1]

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        for t in self._threads:
            t.join(timeout=10.0)

    def run(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        bound = self.start(host, port)
        print(f"serving on http://{host}:{bound}  (ctrl-c to stop)", flush=True)
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
