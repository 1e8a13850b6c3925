"""Live interactive session: the reference's interactive scene as a terminal loop.

The reference edits every simulation parameter at runtime with immediate
visual feedback (main.gd:57-121: per-cascade tabs for all spectrum/scale
fields, resolution and update-rate combos, FPS readout) and is flown through
with a mouse-captured camera (camera.gd:15-47). This module provides both
for the port's session (the JAX package's `utils/live.py`, on PyTorch): a
full-screen ANSI viewer that renders the live ocean —
by default a 3D perspective view of the DISPLACED clipmap geometry
(models/geometry.py; 'v' toggles the top-down height/foam field) — while
routing keystrokes to `Ocean.set_cascade` (dirty-bit spectrum regeneration,
the same path the reference's setters take), `Ocean.resize`, the update-rate
scheduler, and a `FlyCamera` (wasd move, hjkl look, z/x down/up, m mesh
quality).

Usage: `python demo_torch.py --live` (q quits). Headless/test use: pass `input_fn`
(a callable returning pending keystrokes) and drive `run(max_frames=...)`.
"""
from __future__ import annotations

import sys
import time
from typing import Callable

import numpy as np
import torch

from ..models import shading
from . import graphs
from .observability import FrameStats

# editable fields in panel order (main.gd:92-108) with their step sizes
PARAM_STEPS: dict[str, float] = {
    "wind_speed": 1.0,
    "wind_direction": 5.0,
    "fetch_length": 25.0,
    "swell": 0.1,
    "spread": 0.05,
    "detail": 0.05,
    "whitecap": 0.05,
    "foam_amount": 0.5,
    "tile_length": 4.0,
    "displacement_scale": 0.1,
    "normal_scale": 0.1,
}
RESOLUTIONS = (128, 256, 512, 1024)  # the reference's combo (main.gd:68)

KEY_HELP = ("[1-9] cascade  [tab/`] param  [+/-] adjust  [r] resolution  "
            "[u/U] update rate  [wasd] move  [hjkl] look  [z/x] down/up  "
            "[f/F] fov  [v] view  [m] mesh  [q] quit")


def _sample_field(maps, scales, extent: float, cols: int, rows: int):
    """(rows, cols) height + foam over a world patch, cascade-composited."""
    dev = maps.displacement.device
    xs = torch.linspace(-extent / 2, extent / 2, cols, device=dev)
    zs = torch.linspace(-extent / 2, extent / 2, rows, device=dev)
    xz = torch.stack(torch.meshgrid(xs, zs, indexing="xy"), dim=-1)  # (rows, cols, 2)
    disp = shading.cascade_displacement(maps.displacement, scales, xz)
    grad = shading.cascade_gradient(maps.normal, scales, xz)
    return disp[..., 1], grad[..., 2]  # height, foam


# one captured graph a (extent, cols, rows) and maps shape on the card (the
# JAX package's _sample_field_jit, static_argnums=(2, 3, 4))
_sample_field_graphed = graphs.graphed(_sample_field)


def ansi_field(height: np.ndarray, foam: np.ndarray,
               water_color=None, foam_color=None) -> str:
    """Truecolor half-block rendering: 2 field rows per text line.

    Water tinted by the session's global water color, brightened with
    height; foam lerps toward the global foam color — the same two shader
    globals every reference material reads (water.gd:14-18,
    project.godot:60-81). Colors are linear RGB; None keeps the defaults.
    """
    h = np.asarray(height, np.float32)
    f = np.clip(np.asarray(foam, np.float32), 0.0, 1.0)
    wc = np.asarray(water_color if water_color is not None
                    else shading.DEFAULT_WATER_COLOR, np.float32)
    fc = np.asarray(foam_color if foam_color is not None
                    else shading.DEFAULT_FOAM_COLOR, np.float32)
    wc_srgb = np.clip(wc, 0.0, 1.0) ** (1 / 2.2) * 255.0
    fc_srgb = np.clip(fc, 0.0, 1.0) ** (1 / 2.2) * 255.0
    scale = max(1e-6, float(np.percentile(np.abs(h), 95)))
    t = np.clip(h / (2 * scale) + 0.5, 0.0, 1.0)[..., None]
    # troughs dark, crests toward a sky-lit brightening of the water tint
    base = wc_srgb * (0.25 + 1.05 * t) + np.float32(70.0) * t
    rgb = np.clip(base * (1 - f[..., None]) + fc_srgb * 1.25 * f[..., None],
                  0, 255).astype(np.uint8)
    return ansi_rgb(rgb)


def ansi_rgb(rgb: np.ndarray) -> str:
    """Truecolor half-block encoding of an (H, W, 3) uint8 image
    (2 image rows per text line)."""
    lines = []
    for y in range(0, rgb.shape[0] - 1, 2):
        row = []
        for x in range(rgb.shape[1]):
            tr, tg, tb = rgb[y, x]
            br, bg, bb = rgb[y + 1, x]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


class LiveViewer:
    """Terminal session: simulate, render, edit, fly — the C1/C2/C14
    capability."""

    def __init__(self, ocean, fps: float = 20.0, cols: int = 96,
                 rows: int = 44, extent: float | None = None,
                 input_fn: Callable[[], str] | None = None, output=None,
                 view: str = "3d", mesh_quality: str = "low",
                 spray: bool = False, spray_particles: int = 32768):
        from ..models.camera import FlyCamera
        from ..models.ocean import require_one_size
        require_one_size(ocean, "LiveViewer")
        self.ocean = ocean
        self.dt = 1.0 / fps
        self.cols, self.rows = cols, rows
        # default view: one tile of the largest cascade
        self.extent = extent or float(ocean.params.tile_length.max())
        self.cascade = 0
        self.param_names = list(PARAM_STEPS)
        self.param_idx = 0
        self.stats = FrameStats()
        self.quit = False
        self.view = view                      # "3d" | "field" ('v' toggles)
        self.mesh_quality = mesh_quality      # water.gd:43-46 ('m' toggles)
        self.camera = FlyCamera(
            position=np.array([0.0, 10.0, -30.0]), pitch=-0.25)
        self._render3d = None                 # built lazily per mesh quality
        # spray in the 3D view (the scene renders it always, main.tscn:133-140)
        self.spray = spray
        from ..models.viewport import SpraySession
        self._spray = SpraySession(num_particles=spray_particles, device=ocean.device)
        self._input_fn = input_fn
        self._out = output if output is not None else sys.stdout
        self._maps = None
        # host mirror of the edited params for the status line: a read of the
        # card's params waits for the frames in flight; refreshed on edits
        self._param_cache: dict | None = None

    # --- input ---------------------------------------------------------

    def _read_keys(self) -> str:
        if self._input_fn is not None:
            return self._input_fn()
        import select
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if not ch:
                break
            keys.append(ch)
        return "".join(keys)

    def handle_key(self, ch: str) -> None:
        o = self.ocean
        if ch == "q":
            self.quit = True
        elif ch.isdigit() and ch != "0" and int(ch) <= o.num_cascades:
            self.cascade = int(ch) - 1
        elif ch == "\t":
            self.param_idx = (self.param_idx + 1) % len(self.param_names)
        elif ch == "`":
            self.param_idx = (self.param_idx - 1) % len(self.param_names)
        elif ch in "+-=_":
            name = self.param_names[self.param_idx]
            step = PARAM_STEPS[name] * (1 if ch in "+=" else -1)
            cur = self._params_host()[name][self.cascade]
            new = float(np.atleast_1d(cur)[0]) + step
            o.set_cascade(self.cascade, **{name: new})
            self._param_cache = None
        elif ch == "r":
            i = RESOLUTIONS.index(o.config.map_size) \
                if o.config.map_size in RESOLUTIONS else 0
            o.resize(RESOLUTIONS[(i + 1) % len(RESOLUTIONS)])
            self._maps = None
        elif ch == "u":
            o.updates_per_second = max(0.0, o.updates_per_second - 5.0)
        elif ch == "U":
            o.updates_per_second = min(60.0, o.updates_per_second + 5.0)
        elif ch in "cC":
            # add ('C') / remove ('c') a cascade at runtime (water.gd:22-35;
            # same path as the web panel's +/- buttons)
            from ..models.cascade import CascadeParams
            want = o.num_cascades + (1 if ch == "C" else -1)
            if 1 <= want <= 8:
                stacks = [o.params.map(lambda x, i=i: x[i])
                          for i in range(min(want, o.num_cascades))]
                while len(stacks) < want:
                    stacks.append(CascadeParams.create(device=o.device))
                o.set_cascades(stacks)
                self.cascade = min(self.cascade, want - 1)
                self._maps = None
                self._param_cache = None
        # --- fly camera (camera.gd:15-47) + view toggles ---
        elif ch in "wasdzx":
            move = {"w": (1, 0, 0), "s": (-1, 0, 0), "a": (0, -1, 0),
                    "d": (0, 1, 0), "x": (0, 0, 1), "z": (0, 0, -1)}[ch]
            self.camera.move(0.15, *move)
        elif ch in "hjkl":
            dx, dy = {"h": (-24, 0), "l": (24, 0),
                      "k": (0, -24), "j": (0, 24)}[ch]
            self.camera.look(dx, dy)
        elif ch in "fF":
            # the reference panel's FOV control, 20-170 (main.gd:113-114)
            self.camera.fov_deg = float(np.clip(
                self.camera.fov_deg + (5.0 if ch == "F" else -5.0),
                20.0, 170.0))
        elif ch == "v":
            self.view = "field" if self.view == "3d" else "3d"
        elif ch == "m":
            self.mesh_quality = "high" if self.mesh_quality == "low" else "low"
            self._render3d = None

    # --- frame loop ------------------------------------------------------

    def _params_host(self) -> dict:
        if self._param_cache is None:
            p = self.ocean.params                   # one .cpu() of each field
            self._param_cache = {name: getattr(p, name).detach().cpu().numpy()
                                 for name in self.param_names}
        return self._param_cache

    def status_line(self) -> str:
        o = self.ocean
        name = self.param_names[self.param_idx]
        val = self._params_host()[name][self.cascade]
        val = float(np.atleast_1d(val)[0])
        s = self.stats.summary()
        cam = self.camera.position
        pose = (f"cam [{cam[0]:.0f} {cam[1]:.0f} {cam[2]:.0f}] "
                f"fov {self.camera.fov_deg:.0f}  "
                if self.view == "3d" else "")
        return (f"cascade {self.cascade + 1}/{o.num_cascades}  "
                f"{name}={val:.2f}  map {o.config.map_size}^2  "
                f"ups={o.updates_per_second:g}  {pose}"
                f"{s.get('fps', 0.0):.1f} fps / {s.get('ms_p50', 0.0):.1f} ms")

    def _build_render3d(self):
        """models/viewport.SceneRenderer (shared with demo_torch.py);
        half-blocks give 2 pixels per terminal line."""
        from ..models.viewport import SceneRenderer
        return SceneRenderer(self.cols, self.rows * 2,
                             mesh_quality=self.mesh_quality,
                             environment=True,
                             march_steps=28, bisect_steps=6)

    def frame(self) -> str:
        t0 = time.perf_counter()
        maps = self.ocean.update(self.dt)
        if maps is not None:
            self._maps = maps
        if self._maps is None:
            return ""
        scales = self.ocean.params.map_scales()
        if self.view == "3d":
            if self._render3d is None:
                self._render3d = self._build_render3d()
            cam = self.camera
            attrs = (self._spray.advance(self._maps, scales, self.dt)
                     if self.spray else None)
            img = self._render3d.render(
                self._maps, scales, self.ocean.water_color,
                self.ocean.foam_color, cam.position,
                np.rad2deg(cam.pitch), np.rad2deg(cam.yaw),
                fov=cam.fov_deg, spray_attrs=attrs)
            body = ansi_rgb(img.cpu().numpy())
        else:
            height, foam = _sample_field_graphed(
                self._maps, scales, self.extent, self.cols, self.rows)
            body = ansi_field(height.cpu().numpy(), foam.cpu().numpy(),
                              water_color=self.ocean.water_color,
                              foam_color=self.ocean.foam_color)
        self.stats.record(time.perf_counter() - t0)
        return f"{body}\n{self.status_line()}\n{KEY_HELP}"

    def run(self, max_frames: int | None = None) -> None:
        interactive = self._input_fn is None and sys.stdin.isatty()
        ctx = _RawTerminal() if interactive else _NullCtx()
        self._out.write("\x1b[2J")  # clear once; then repaint from home
        with ctx:
            n = 0
            while not self.quit and (max_frames is None or n < max_frames):
                for ch in self._read_keys():
                    self.handle_key(ch)
                if self.quit:
                    break
                text = self.frame()
                self._out.write("\x1b[H" + text + "\n")
                self._out.flush()
                n += 1
                if interactive:
                    time.sleep(max(0.0, self.dt - 0.001))
        self._out.write("\x1b[0m\n")


class _RawTerminal:
    """cbreak stdin so single keystrokes arrive without Enter."""

    def __enter__(self):
        import termios
        import tty
        self._fd = sys.stdin.fileno()
        self._old = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        import termios
        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass
