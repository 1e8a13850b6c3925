"""Sea-spray particle system (reference C13) as a vectorized state machine.

Counterpart of the JAX package's `models/spray.py`: the process shader
assets/shaders/spatial/sea_spray_particle.gdshader (the GPUParticles3D of
main.tscn:133-140) over one `SprayState` of per-particle tensors, advanced
by `spray_step`. On the card a step is one launch of `csrc/spray.cu`
(`ops/spray.py`), a thread a particle; any other device runs
`spray_step_plain`, where the per-particle branches (waiting / just started
/ alive / expired) are `torch.where` masks and the respawn cycle
re-randomizes through the reference's hash32 (`ops.rng.hash32_uvec2`). The
kernel equals the plain route on the card bit for bit. A step reads nothing
back to the host: `now`, the cycle counters and the masks stay on the
particles' device, and the plain route's constants are cached there
(`shading._const`).

Particle lifecycle (gdshader line refs):
  placement: sqrt(P) x sqrt(P) grid over a 10x10 local box, scaled by the
    emitter transform (:45-54, main.tscn:134 scale 15)
  staggered starts + lifetime randomness (:57-59)
  activation gate: foam > 0.9 AND normal.y in the [0.92, 0.99] band (:79-95)
  motion: ride the displacement maps (x0.75 horizontally) + parabolic
    vertical impulse (:105-115)
  scale shaping: exp_impulse / log1p envelopes (:118-124)
  dissolve driver CUSTOM.a = exp_impulse(t, 10) (:100)

The billboard/dissolve consumer math (sea_spray.gdshader) lives in
`billboard_alpha`, and the composite in `shading.splat_spray`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import spray as spray_kernel
from ..ops.rng import hash32_uvec2
from . import shading
from .cascade import require_device


@dataclasses.dataclass(frozen=True)
class SprayParams:
    """Emitter configuration (main.tscn:133-140 + shader uniforms)."""
    num_particles: int = 32768          # main.tscn:137
    system_lifetime: float = 6.0        # main.tscn:138 (LIFETIME)
    lifetime: float = 3.0               # shader uniform `lifetime` (:21)
    lifetime_randomness: float = 0.25   # (:22)
    emitter_extent: float = 75.0        # 10-unit box * 15 emitter scale / 2
    particle_scale: tuple = (1.0, 1.0, 1.0)
    seed: int = 0


@dataclasses.dataclass
class SprayState:
    """Per-particle state (the USERDATA registers of the reference)."""
    start_pos: torch.Tensor       # (P, 3) world spawn position
    start_time: torch.Tensor      # (P,)
    lifetime: torch.Tensor        # (P,) per-particle lifetime
    custom_z: torch.Tensor        # (P,) dissolve offset (CUSTOM.z)
    scale_factor: torch.Tensor    # (P,) SCALE_FACTOR
    base_scale: torch.Tensor      # (P, 3) PARTICLE_SCALE
    active: torch.Tensor          # (P,) bool
    has_started: torch.Tensor     # (P,) bool
    cycle: torch.Tensor           # (P,) int32 respawn counter

    def replace(self, **changes) -> "SprayState":
        return dataclasses.replace(self, **changes)


def exp_impulse(x, k):
    """iq's impulse shaping function (gdshader:69-72)."""
    h = k * x
    return h * torch.exp(1.0 - h)


def _now(now, device: torch.device) -> torch.Tensor:
    """`now` as a 0-d fp32 tensor on `device`: a tensor moves (no copy if it
    is there), a number fills on the device (no host-to-device copy)."""
    if isinstance(now, torch.Tensor):
        return now.to(device=device, dtype=torch.float32)
    return torch.full((), float(np.float32(now)), dtype=torch.float32, device=device)


def _spawn(params: SprayParams, idx: torch.Tensor, cycle: torch.Tensor, now: torch.Tensor):
    """(Re)spawn: grid placement + staggered start (gdshader:45-66)."""
    p = params.num_particles
    # t = floor(sqrt(P)) exactly as gdshader:47; for non-square P (incl. the
    # scene's 32768) the reference's own grid is ragged: the last partial
    # row's x-index exceeds t-1, overshooting the emitter box slightly.
    # Preserved for parity (docs/PARITY.md).
    t = int(p ** 0.5)
    # idx + cycle * P and 1 + cycle + seed wrap as int32 in the reference;
    # in int64 they differ from that by multiples of 2^32, which the hash's
    # uint32 cast removes
    i64, c64 = idx.to(torch.int64), cycle.to(torch.int64)
    r0, r1, r2 = hash32_uvec2(i64 + c64 * p, 1 + c64 + params.seed)
    gx = torch.div(idx, t, rounding_mode="floor").to(torch.float32)
    gy = torch.remainder(idx, t).to(torch.float32)
    coords = (torch.stack([gx, gy], -1) / (t - 1.0) - 0.5) * 2.0 * params.emitter_extent
    start_pos = torch.stack([coords[..., 0], torch.zeros_like(r0), coords[..., 1]], -1)
    lifetime = params.lifetime - params.lifetime * params.lifetime_randomness * r1
    start_time = now + r2 * (params.system_lifetime - lifetime)
    return start_pos, start_time, lifetime, r0


def spray_init(params: SprayParams, device: torch.device | str = "cuda") -> SprayState:
    """Fresh particles on `device` (defaults to the card and raises without
    one; pass device="cpu" to stay on the CPU)."""
    device = require_device(device)
    p = params.num_particles
    idx = torch.arange(p, dtype=torch.int32, device=device)
    cycle = torch.zeros(p, dtype=torch.int32, device=device)
    start_pos, start_time, lifetime, r0 = _spawn(params, idx, cycle, _now(0.0, device))
    zeros = torch.zeros(p, dtype=torch.float32, device=device)
    return SprayState(
        start_pos=start_pos, start_time=start_time, lifetime=lifetime,
        custom_z=r0, scale_factor=zeros,
        base_scale=torch.zeros((p, 3), dtype=torch.float32, device=device),
        active=torch.zeros(p, dtype=torch.bool, device=device),
        has_started=torch.zeros(p, dtype=torch.bool, device=device),
        cycle=cycle,
    )


def spray_step(params: SprayParams, state: SprayState, maps, map_scales: torch.Tensor,
               now) -> tuple[SprayState, dict]:
    """Advance all particles to wall-time `now` (a number or a 0-d tensor);
    returns the new state and the render attributes.

    maps: OceanMaps (channel-first); map_scales: (C, 4). Output dict:
    position (P, 3), scale (P, 3), dissolve (P,), custom_z (P,), visible (P,).
    A state on the card takes one launch of the spray kernel
    (`ops/spray.py`, `launches.spray`); any other runs `spray_step_plain`.
    """
    dev = state.start_time.device
    if dev.type != "cuda":
        return spray_step_plain(params, state, maps, map_scales, now)
    fields, (position, scale, dissolve, visible) = spray_kernel.spray_step(
        params, [getattr(state, name) for name in spray_kernel.FIELDS], maps.displacement,
        maps.normal, map_scales, _now(now, dev))
    new_state = SprayState(**dict(zip(spray_kernel.FIELDS, fields)))
    return new_state, {"position": position, "scale": scale, "dissolve": dissolve,
                       "custom_z": new_state.custom_z, "visible": visible}


def spray_step_plain(params: SprayParams, state: SprayState, maps, map_scales: torch.Tensor,
                     now) -> tuple[SprayState, dict]:
    """`spray_step` as PyTorch operations, on any device: the CPU's route and
    the kernel's reference on the card."""
    dev = state.start_time.device
    p = params.num_particles
    idx = torch.arange(p, dtype=torch.int32, device=dev)
    now = _now(now, dev)

    expired = now > state.start_time + state.lifetime
    # respawn expired particles into the next cycle (Godot restarts them)
    ncycle = state.cycle + expired.to(torch.int32)
    sp, st, lt, r0 = _spawn(params, idx, ncycle, now)
    start_pos = torch.where(expired[:, None], sp, state.start_pos)
    start_time = torch.where(expired, st, state.start_time)
    lifetime = torch.where(expired, lt, state.lifetime)
    custom_z = torch.where(expired, r0, state.custom_z)
    active = state.active & ~expired
    has_started = state.has_started & ~expired

    started_now = (now >= start_time) & ~has_started
    xz = start_pos[:, 0::2]

    # --- activation sampling (gdshader:76-95): plain bilinear normal read ---
    grad = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    for i in range(maps.normal.shape[0]):
        s = map_scales[i]
        planes = torch.cat([maps.normal[i, 0:2], maps.normal[i, 3:4]]).float()
        tap = shading.sample_bilinear(planes, xz * s[:2])
        grad = grad + torch.movedim(tap, 0, -1)
    ones = torch.ones(p, dtype=torch.float32, device=dev)
    normal = torch.stack([-grad[:, 0], ones, -grad[:, 1]], -1)
    normal = normal / shading._norm(normal)
    foam = grad[:, 2]
    # Reference quirk preserved (sea_spray_particle.gdshader:87-90): GLSL
    # mix() does not clamp, so normal_factor = mix(0.25, 1, min(t, 1)) is
    # ALWAYS <= 1 (the upper-band check is vacuous) and >= 0 down to
    # normal.y ~= 0.8967: the effective activation band is wider than the
    # [0.92, 0.99] the shader comment suggests. See docs/PARITY.md.
    normal_factor = 0.25 + 0.75 * torch.clamp_max((normal[:, 1] - 0.92) / (0.99 - 0.92), 1.0)
    foam_factor = 0.25 + 0.75 * torch.clamp_max((foam - 0.9) / (1.0 - 0.9), 1.0)
    activate = (normal_factor >= 0.0) & (normal_factor <= 1.0) & (foam > 0.9)

    active = torch.where(started_now, activate, active)
    scale_factor = torch.where(started_now, normal_factor * foam_factor, state.scale_factor)
    pscale = shading._const(tuple(float(v) for v in params.particle_scale), dev)
    base = ((foam_factor * (activate.to(torch.float32) + 1e-3))[:, None]
            * torch.stack([ones, normal_factor, ones], -1) * pscale)
    base_scale = torch.where(started_now[:, None], base, state.base_scale)
    has_started = has_started | started_now

    # --- alive-particle animation (gdshader:98-125) ---
    t = torch.clamp((now - start_time) / lifetime, 0.0, 1.0)
    disp = shading.cascade_displacement(maps.displacement, map_scales, xz)
    disp = disp * shading._const((0.75, 1.0, 0.75), dev)
    parabola = -5.0 * torch.square(2.5 * t - 0.45) * scale_factor + 0.5
    zeros = torch.zeros(p, dtype=torch.float32, device=dev)
    position = start_pos + disp + torch.stack([zeros, parabola, zeros], -1)

    size = (lifetime / params.lifetime) ** 2
    scale_mod = torch.stack([
        torch.log1p(t) * size,
        exp_impulse(t, 3.0) * size,
        torch.log1p(t) * size,
    ], -1)
    scale = base_scale * scale_mod

    visible = active & has_started & (now >= start_time)
    new_state = SprayState(
        start_pos=start_pos, start_time=start_time, lifetime=lifetime,
        custom_z=custom_z, scale_factor=scale_factor, base_scale=base_scale,
        active=active, has_started=has_started, cycle=ncycle,
    )
    return new_state, {
        "position": position,
        "scale": scale,
        "dissolve": exp_impulse(t, 10.0),   # CUSTOM.a (gdshader:100)
        "custom_z": custom_z,               # dissolve offset (CUSTOM.z)
        "visible": visible,
    }


def billboard_alpha(dissolve, custom_z, distance, dissolve_noise,
                    max_alpha: float = 0.666) -> torch.Tensor:
    """Spray billboard opacity (sea_spray.gdshader:30-33).

    alpha = max_alpha * distance_fade * max((fade + offset)/2 - noise, 0);
    texture alpha and the scrolling noise sample are caller-provided.
    """
    distance_fade = 1.0 - torch.exp(-distance * 0.04)
    return max_alpha * distance_fade * torch.clamp_min(
        (dissolve + custom_z) * 0.5 - dissolve_noise, 0.0)
