"""Scene renderer, frame pipeline and persistent spray session.

Counterpart of the JAX package's `models/viewport.py`. Every render surface
(`demo_torch.py`'s offline frame loop, the ANSI live viewer `utils/live.py`)
needs the same plumbing: the scene render, the spray composite, the
quantize to gamma-encoded uint8 on the device (so a frame crosses to the
host as its finished bytes), the fetch overlapped with the next frame's
work, and the lazily created persistent spray state (the reference scene
always renders its 32768-particle spray, main.tscn:133-140). This module is
its single owner, so the surfaces cannot drift apart.

On the card each of the JAX package's jitted programs here is a captured
CUDA graph (`utils/graphs.py`), replayed once a call: the render with or
without the spray composite (one K5 launch inside), the spray step, and
the K-frame step (K1's multi-frame launch, then a spray step and a render a
tick). The pose, the colours and the clocks reach the card as tensors
through one non-blocking copy a call, so a replay never bakes in the first
call's numbers. Nothing reads back to the host, so the host runs ahead and
`FramePipeline` overlaps each frame's device-to-host copy with the next
frame's work. `graphs.disabled()` runs the same programs eagerly.
"""
from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from . import geometry, shading, spray
from .cascade import require_device
from ..utils import graphs

# --- render quality tiers ---------------------------------------------------
# The JAX package's presets (its viewport.py:37-43; there timed on a TPU,
# not here). Keys are render_ocean_geometry kwargs: "quality" is the
# offline default, "interactive" the viewers' default, "performance"
# coarser shading blocks.
RENDER_TIERS: dict[str, dict] = {
    "quality": dict(march_steps=40, bisect_steps=8),
    "interactive": dict(march_steps=32, bisect_steps=6, shade_res=2,
                        bracket_res=128, invert_res=256),
    "performance": dict(march_steps=32, bisect_steps=6, shade_res=3,
                        bracket_res=128, invert_res=256),
}


# --- wire formats ----------------------------------------------------------
# BT.601 full-range RGB<->YCbCr (the JPEG convention, ITU-T T.871). A viewer
# that JPEG-encodes at 4:2:0 loses nothing more when the chroma is
# subsampled on the device, and the frame crosses to the host at 1.5 B/px
# instead of 3.


def _rgb_to_yuv420(srgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) float sRGB-encoded [0, 255] -> flat uint8 Y + Cb + Cr planes
    (chroma 2x2-mean subsampled). H and W must be even.

    RGB->CbCr is affine, so the 2x2 mean commutes with it: the RGB planes
    are subsampled first and the chroma matrix runs on the quarter-size
    planes."""
    r, g, b = srgb[..., 0], srgb[..., 1], srgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    h, w = y.shape

    def sub(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))

    rs, gs, bs = sub(r), sub(g), sub(b)
    cb = 128.0 - 0.168736 * rs - 0.331264 * gs + 0.5 * bs
    cr = 128.0 + 0.5 * rs - 0.418688 * gs - 0.081312 * bs
    q = lambda c: torch.clamp(torch.round(c), 0.0, 255.0).to(torch.uint8)
    return torch.cat([q(y).reshape(-1), q(cb).reshape(-1), q(cr).reshape(-1)])


def yuv420_to_ycbcr(flat: np.ndarray, height: int, width: int) -> np.ndarray:
    """Host-side unpack of the YUV420 wire format -> (H, W, 3) uint8 YCbCr
    (chroma nearest-upsampled; feed straight to a JPEG encoder)."""
    flat = np.asarray(flat)
    n, q = height * width, (height // 2) * (width // 2)
    y = flat[:n].reshape(height, width)
    cb = flat[n:n + q].reshape(height // 2, width // 2)
    cr = flat[n + q:].reshape(height // 2, width // 2)
    up = lambda c: np.repeat(np.repeat(c, 2, axis=0), 2, axis=1)
    return np.stack([y, up(cb), up(cr)], axis=-1)


def ycbcr_to_rgb(ycbcr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 full-range YCbCr -> uint8 RGB (BT.601 inverse)."""
    y = ycbcr[..., 0].astype(np.float32)
    cb = ycbcr[..., 1].astype(np.float32) - 128.0
    cr = ycbcr[..., 2].astype(np.float32) - 128.0
    rgb = np.stack([y + 1.402 * cr,
                    y - 0.344136 * cb - 0.714136 * cr,
                    y + 1.772 * cb], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def _color(c):
    """A host colour (sequence or array of 3) as fp32-rounded Python floats,
    the form `shading` caches its device constants by; a tensor stays as it
    is."""
    if isinstance(c, torch.Tensor):
        return c
    return tuple(float(v) for v in np.asarray(c, np.float32).reshape(3))


def _pose_scalar(v):
    """A pose number rounded to fp32 (as the JAX package's jnp.float32);
    a tensor stays as it is."""
    return v if isinstance(v, torch.Tensor) else float(np.float32(v))


def _frame_args(host: graphs.HostValues, device, wc, fc, pos, pitch, yaw, fov,
                *clock) -> tuple:
    """``(wc, fc, pos, pitch, yaw, fov, *clock)`` for a frame program. On
    the card every host number among them reaches the device in one staged
    copy (`graphs.HostValues`), so a replay reads this call's values;
    eagerly (the CPU, or inside `graphs.disabled()`) colours and scalars
    are rounded to fp32 and the camera position passes as it is."""
    if device.type == "cuda" and graphs.enabled():
        return tuple(host.put([wc, fc, pos, pitch, yaw, fov, *clock], device))
    return (_color(wc), _color(fc), pos, *(_pose_scalar(v) for v in (pitch, yaw, fov, *clock)))


def _weak(obj, name: str):
    """`obj.name` called through a weak reference: a graph cache held by
    `obj` does not keep `obj` alive."""
    ref = weakref.ref(obj)
    return lambda *args: getattr(ref(), name)(*args)


class SceneRenderer:
    """Render closures for one viewport configuration.

    ``flat=False`` renders the vertex-displaced clipmap mesh
    (`geometry.render_ocean_geometry`: silhouettes and parallax, the
    reference's defining visual); ``flat=True`` the cheap y=0 raycast
    (`shading.render_ocean`). The camera pose (numbers or tensors on the
    maps' device) and the session's global colours (water.gd:14-18, host
    values or (3,) tensors) are call arguments.

    On the card `render` replays one captured CUDA graph a call (one per
    map shape and dtype, with and without spray), and the graphs of one
    renderer share one memory pool.

    ``transfer`` picks the wire format: ``"rgb"`` = (H, W, 3) uint8,
    ``"yuv420"`` = flat uint8 planar Y/Cb/Cr at 1.5 B/px (unpack with
    `yuv420_to_ycbcr`; needs even width and height).

    Extra keyword arguments (``shade_res``, ``bracket_res``, ``sampler``,
    ...) forward to `render_ocean_geometry`; ignored when ``flat=True``.
    """

    def __init__(self, width: int, height: int, *, flat: bool = False,
                 mesh_quality: str = "high", environment: bool = True,
                 march_steps: int = 40, bisect_steps: int = 8,
                 transfer: str = "rgb", **render_kwargs):
        if transfer not in ("rgb", "yuv420"):
            raise ValueError(f"unknown transfer format {transfer!r}")
        if transfer == "yuv420" and (width % 2 or height % 2):
            raise ValueError("yuv420 transfer needs even width/height")
        self.width = width
        self.height = height
        self.flat = flat
        self.mesh_quality = mesh_quality
        self.environment = environment
        self.march_steps = march_steps
        self.bisect_steps = bisect_steps
        self.transfer = transfer
        # the displaced-geometry knobs this renderer was built with
        self.render_kwargs = dict(render_kwargs)
        self.pool = graphs.Pool()
        self.programs = {"render": graphs.graphed(_weak(self, "_render"), self.pool),
                         "render_spray": graphs.graphed(_weak(self, "_render_spray"), self.pool)}
        self._host = graphs.HostValues()

    def _scene(self, maps, scales, wc, fc, pos, pitch, yaw, fov) -> torch.Tensor:
        pose = dict(width=self.width, height=self.height, camera_pos=pos,
                    pitch_deg=pitch, yaw_deg=yaw, fov_deg=fov,
                    environment=self.environment, water_color=wc, foam_color=fc)
        if self.flat:
            return shading.render_ocean(maps, scales, **pose)
        return geometry.render_ocean_geometry(
            maps, scales, self.mesh_quality, march_steps=self.march_steps,
            bisect_steps=self.bisect_steps, **pose, **self.render_kwargs)

    def _quantize(self, img: torch.Tensor) -> torch.Tensor:
        srgb = torch.clamp(img, 0.0, 1.0) ** (1 / 2.2) * 255
        if self.transfer == "yuv420":
            return _rgb_to_yuv420(srgb)
        return srgb.to(torch.uint8)

    def _render(self, maps, scales, wc, fc, pos, pitch, yaw, fov) -> torch.Tensor:
        return self._quantize(self._scene(maps, scales, wc, fc, pos, pitch, yaw, fov))

    def _render_spray(self, maps, scales, wc, fc, pos, pitch, yaw, fov, attrs) -> torch.Tensor:
        img = self._scene(maps, scales, wc, fc, pos, pitch, yaw, fov)
        img = shading.splat_spray(
            img, attrs["position"], attrs["scale"], attrs["dissolve"],
            attrs["visible"], camera_pos=pos, pitch_deg=pitch, yaw_deg=yaw,
            fov_deg=fov, foam_color=fc, custom_z=attrs["custom_z"])
        return self._quantize(img)

    def render(self, maps, scales, water_color, foam_color, pos, pitch, yaw,
               spray_attrs=None, fov=70.0) -> torch.Tensor:
        """One frame on the maps' device, as uint8 in the configured wire
        format (``"rgb"``: gamma-encoded (H, W, 3); ``"yuv420"``: flat
        planar). ``fov`` is part of the pose (the reference panel's FOV
        20-170 slider, main.gd:113-114). Reads nothing back to the host.
        On the card the frame is a copy of the graph's output: the next
        call does not overwrite it (the JAX package returns a new array a
        call too)."""
        args = _frame_args(self._host, maps.displacement.device, water_color, foam_color,
                           pos, pitch, yaw, fov)
        if spray_attrs is None:
            return self.programs["render"](maps, scales, *args)
        return self.programs["render_spray"](maps, scales, *args, spray_attrs)


class FramePipeline:
    """Overlap a frame's device-to-host copy with the next frame's work.

    `push(img)` starts a non-blocking copy of the frame into a pinned host
    buffer, records an event behind it, and returns the PREVIOUS frame as
    a host array of the caller's own (None on the first push), waiting on
    that frame's event only: the work queued since (the new frame) keeps
    the card busy while the host takes the old one. `flush()` returns the
    last pending frame. Two buffers rotate, so a copy in flight is never
    overwritten. One frame of extra latency. A frame on the CPU is copied
    synchronously; a NumPy frame is taken as it is.
    """

    def __init__(self):
        self._pending = None          # (host tensor, event or None)
        self._buffers: list[torch.Tensor] = []
        self._slot = 0

    def _start(self, img):
        if not isinstance(img, torch.Tensor):
            return torch.from_numpy(np.array(img)), None
        if img.device.type != "cuda":
            return img.detach().to("cpu", copy=True), None
        if not self._buffers or (self._buffers[0].shape != img.shape
                                 or self._buffers[0].dtype != img.dtype):
            self._buffers = [torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
                             for _ in range(2)]
        buf = self._buffers[self._slot]
        self._slot ^= 1
        buf.copy_(img, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(img.device))
        return buf, event

    @staticmethod
    def _finish(pending) -> np.ndarray | None:
        if pending is None:
            return None
        buf, event = pending
        if event is None:
            return buf.numpy()
        event.synchronize()
        return buf.numpy().copy()

    def push(self, img) -> np.ndarray | None:
        prev, self._pending = self._pending, self._start(img)
        return self._finish(prev)

    def flush(self) -> np.ndarray | None:
        prev, self._pending = self._pending, None
        return self._finish(prev)

    def discard(self) -> None:
        """Drop the pending frame WITHOUT returning it: for mode or shape
        transitions where the pending payload no longer matches what the
        caller would serve."""
        self._pending = None


# The spray step as one captured graph on the card, shared by every session
# (keyed by its params, the particle count and the maps' shape and dtype):
# a throwaway session that warms a configuration captures the graph the live
# session then replays.
_spray_step = graphs.graphed(spray.spray_step)


class SpraySession:
    """Persistent spray particle state, shared across renderer rebuilds (a
    mesh-quality or resolution change must not reset the particles'
    respawn cycles). The particles live on `device` (defaults to the card
    and raises without one; pass device="cpu" to stay on the CPU)."""

    def __init__(self, num_particles: int = 32768, emitter_extent: float = 60.0,
                 device: torch.device | str = "cuda"):
        self.device = require_device(device)
        self._num_particles = num_particles
        self._emitter_extent = emitter_extent
        self._params = None
        self._state = None
        self._host = graphs.HostValues()
        self.clock = 0.0

    @property
    def started(self) -> bool:
        """True once the particle state exists (first advance() ran)."""
        return self._state is not None

    def ensure_init(self):
        """Create the particle state if it does not exist yet; returns
        ``(params, state)``. The batched frame loop threads the spray
        recurrence itself instead of calling `advance`."""
        if self._state is None:
            self._params = spray.SprayParams(num_particles=self._num_particles,
                                             emitter_extent=self._emitter_extent)
            self._state = spray.spray_init(self._params, device=self.device)
        return self._params, self._state

    def advance(self, maps, scales, dt: float) -> dict:
        """Step the particle state machine by dt -> billboard attrs dict
        (feed to SceneRenderer.render(spray_attrs=...)); on the card one
        replay of the shared spray-step graph."""
        params, state = self.ensure_init()
        self.clock += dt
        now = np.float32(self.clock)
        if self.device.type == "cuda" and graphs.enabled():
            (now,) = self._host.put([now], self.device)
        self._state, attrs = _spray_step(params, state, maps, scales, now)
        return attrs

    def checkpoint(self) -> dict | None:
        """Snapshot of the particle state machine (None before the first
        advance): params, the state's fields as CPU tensors (int32 cycle and
        the bools kept), the clock. Companion of `Ocean.checkpoint`."""
        if self._state is None:
            return None
        from ..utils.hostio import device_get_tree
        return {
            "params": dataclasses.asdict(self._params),
            "state": device_get_tree({f.name: getattr(self._state, f.name)
                                      for f in dataclasses.fields(self._state)}),
            "clock": self.clock,
        }

    def restore(self, snapshot: dict | None) -> None:
        """Restore a `checkpoint()` snapshot onto this session's device
        (None -> reset to unstarted)."""
        if snapshot is None:
            self._params = self._state = None
            self.clock = 0.0
            return
        from ..utils.hostio import device_put_tree
        p = dict(snapshot["params"])
        p["particle_scale"] = tuple(p["particle_scale"])
        self._params = spray.SprayParams(**p)
        self._num_particles = self._params.num_particles
        self._emitter_extent = self._params.emitter_extent
        self._state = spray.SprayState(**device_put_tree(dict(snapshot["state"]), self.device))
        self.clock = float(snapshot["clock"])


def make_batched_step(renderer: SceneRenderer, config, spray_params, num_frames: int):
    """The K-frame step: advance the simulation ``num_frames`` ticks and
    render every tick's frame.

    The maps of all ticks come from one `step_frames` call (on the fused
    tier, one call of the fused kernel's multi-frame wrapper: a row and a
    column pass a frame, the spectra read in place), then a spray step and
    a render per tick. Semantics match K sequential
    ``Ocean.update(dt)`` calls at ``updates_per_second == 0`` followed by a
    spray advance and a render per tick, up to the fp32 clock: here it
    accumulates on the device in fp32. On the card the whole step is one
    captured graph (keyed by the shapes and ``dt``; the clock, the pose and
    the colours go in as tensors), in the renderer's memory pool.

    Returns ``fn(state, params, spray_state, clock, wc, fc, pos, pitch, yaw,
    fov, dt) -> (state, spray_state, frames, last_maps)`` where ``frames``
    stacks ``num_frames`` wire-format frames on axis 0 and ``last_maps`` is
    the final tick's OceanMaps; none of them is overwritten by the next
    call. Pass ``spray_params=None`` to drop the spray (then ``spray_state``
    is None and returns None).
    """
    from .ocean import OceanMaps, step_frames

    def frames(state, params, spray_state, clock, wc, fc, pos, pitch, yaw, fov, dt):
        state, stacked = step_frames(config, state, params, dt, num_frames)
        scales = params.map_scales()
        clk = spray._now(clock, state.time.device)
        out = []
        for k in range(num_frames):
            maps_k = OceanMaps(displacement=stacked.displacement[:, k],
                               normal=stacked.normal[:, k])
            clk = clk + dt
            if spray_params is not None:
                spray_state, attrs = spray.spray_step(spray_params, spray_state, maps_k,
                                                      scales, clk)
                out.append(renderer._render_spray(maps_k, scales, wc, fc, pos, pitch,
                                                  yaw, fov, attrs))
            else:
                out.append(renderer._render(maps_k, scales, wc, fc, pos, pitch, yaw, fov))
        last = OceanMaps(displacement=stacked.displacement[:, -1],
                         normal=stacked.normal[:, -1])
        return state, spray_state, torch.stack(out), last

    program = graphs.graphed(frames, renderer.pool)
    host = graphs.HostValues()

    def fn(state, params, spray_state, clock, wc, fc, pos, pitch, yaw, fov, dt):
        *args, clock = _frame_args(host, state.time.device, wc, fc, pos, pitch, yaw, fov, clock)
        return program(state, params, spray_state, clock, *args, float(np.float32(dt)))

    fn.program = program
    return fn
