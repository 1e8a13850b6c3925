"""Free-look fly camera (reference C2, assets/player/camera.gd).

The reference's mouse-captured fly camera as a headless controller: yaw/pitch
look, WASD-style planar movement in the look frame, wheel-driven speed scaling
and a sprint multiplier (camera.gd:15-47). Drives `shading.render_ocean`
(which takes position/pitch) and the clipmap follow helper
(utils.clipmap.snap_to_tile, main.gd:32-37).
"""
from __future__ import annotations

import dataclasses

import numpy as np

MOUSE_SENSITIVITY = 0.005       # radians per mouse unit (camera.gd look scale)
SPEED_SCALE_STEP = 1.2          # wheel click multiplier
SPRINT_MULTIPLIER = 3.0         # shift boost
PITCH_LIMIT = np.pi / 2 - 1e-3


@dataclasses.dataclass
class FlyCamera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 12.0, 0.0]))
    yaw: float = 0.0            # radians, 0 = +z forward
    pitch: float = -0.2         # radians, negative looks down
    speed: float = 10.0         # m/s base speed
    fov_deg: float = 70.0

    # --- look (camera.gd mouse-motion handler) ---
    def look(self, dx: float, dy: float) -> None:
        self.yaw -= dx * MOUSE_SENSITIVITY
        self.pitch = float(np.clip(self.pitch - dy * MOUSE_SENSITIVITY,
                                   -PITCH_LIMIT, PITCH_LIMIT))

    # --- wheel speed scaling (camera.gd:15-25) ---
    def scroll(self, clicks: int) -> None:
        self.speed = float(np.clip(
            self.speed * SPEED_SCALE_STEP ** clicks, 0.1, 1000.0))

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(forward, right, up) world vectors of the look frame."""
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        forward = np.array([-sy * cp, sp, cy * cp])
        right = np.array([cy, 0.0, sy])
        up = np.cross(right, forward)
        return forward, right, up

    # --- movement (camera.gd:27-47) ---
    def move(self, dt: float, forward: float = 0.0, strafe: float = 0.0,
             rise: float = 0.0, sprint: bool = False) -> np.ndarray:
        f, r, _ = self.basis()
        v = f * forward + r * strafe + np.array([0.0, rise, 0.0])
        norm = np.linalg.norm(v)
        if norm > 1e-9:
            v = v / norm
        speed = self.speed * (SPRINT_MULTIPLIER if sprint else 1.0)
        self.position = self.position + v * speed * dt
        return self.position

    def render_kwargs(self) -> dict:
        """Arguments for shading.render_ocean (same yaw/pitch conventions)."""
        return {
            "camera_pos": tuple(float(x) for x in self.position),
            "pitch_deg": float(np.rad2deg(self.pitch)),
            "yaw_deg": float(np.rad2deg(self.yaw)),
            "fov_deg": self.fov_deg,
        }
