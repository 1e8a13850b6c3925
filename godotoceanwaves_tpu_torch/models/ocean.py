"""The wave-generation engine and session layer (PyTorch port of `models/ocean.py`).

Functional core
---------------
The reference's per-frame GPU pipeline (wave_generator.gd:65-85):

  spectrum_compute (dirty only) -> spectrum_modulate -> FFT rows -> transpose
  -> FFT rows -> fft_unpack

is `step(config, state, params, dt) -> (state, maps)` over a cascade batch.
All cross-frame state (per-cascade time, wave_cascade_parameters.gd:40, and
the persistent foam, fft_unpack.glsl:61-64) lives in an explicit
`OceanState`. Functions return new tensors and never write into the state
they were given, so a kernel never reads a buffer that the same step writes.

A step takes one of three tiers, by map size (`SimConfig.step_tier`): the
fused kernel pair (`ops.fused_step`, 16 <= N <= 1024), the strip kernel pair
(`ops.strip_step`, 1024 < N <= 8192), or the staged modules (modulate ->
planes IFFT -> unpack) for every other N and with `fused="never"`. On a CUDA
device the tiers launch their kernels; on the CPU they run the kernels'
plain PyTorch versions.

Session layer
-------------
`Ocean` mirrors the orchestrator `Water` (water.gd): dirty-bit spectrum
regeneration, the `updates_per_second` scheduler with frame-skip delta
compensation (water.gd:75-82), optional one-cascade-per-call staggering
(wave_generator.gd:56-63), runtime cascade add/remove (`set_cascades`), the
session's global water/foam colours and `checkpoint` / `restore`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..ops import fft, fused_step, initial_state, planes_fft, spectra, strip_step
from ..ops import modulate as modulate_ops, unpack as unpack_ops
from . import shading
from .cascade import (CascadeParams, SimConfig, default_cascades, require_device,
                      stack_cascades)

# Cascade time offsets chosen so cascades don't interfere (water.gd:32).
TIME_OFFSET_BASE = 120.0
TIME_OFFSET_STEP = float(np.pi)


@dataclasses.dataclass
class OceanState:
    """All cross-frame state for a stack of C cascades at resolution N."""
    h0: torch.Tensor      # (C, 2, N, N) float32 — planes of h0(k)
    h0nc: torch.Tensor    # (C, 2, N, N) float32 — planes of conj(h0(-k))
    omega: torch.Tensor   # (C, N, N) float32 — host-exact dispersion omega(k)
    foam: torch.Tensor    # (C, N, N) float32 — persistent foam accumulator
    time: torch.Tensor    # (C,) float32 — per-cascade simulation time

    def replace(self, **changes) -> "OceanState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class OceanMaps:
    """Per-step outputs, channel-first:
    displacement (C, 3, N, N) = (hx, hy, hz);
    normal (C, 4, N, N) = (dhy/dx', dhy/dz', dhx/dx, foam)."""
    displacement: torch.Tensor
    normal: torch.Tensor


def _f32(x):
    """dt rounded to fp32 as `jnp.asarray(dt, jnp.float32)` rounds it.

    A Python float stays a Python float: PyTorch passes it to each kernel as
    an fp32 scalar argument, where a tensor built from it would be a
    pageable host-to-device copy that stalls the host every frame. A tensor
    stays where it is.
    """
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return float(np.float32(x))


def _spectrum_one(config: SimConfig, p: CascadeParams, y_offset: int = 0,
                  rows: int | None = None):
    """Initial spectrum for one cascade (texel rows y_offset .. y_offset +
    rows - 1; all by default); alpha/omega_p from wind speed and fetch
    exactly as wave_generator.gd:68-70 (fetch km -> m)."""
    fetch_m = p.fetch_length * 1e3
    alpha = spectra.jonswap_alpha(p.wind_speed, fetch_m, config.g)
    omega_p = spectra.jonswap_peak_angular_frequency(p.wind_speed, fetch_m, config.g)
    angle = p.wind_direction * float(np.float32(np.pi / 180))   # jnp.deg2rad
    return initial_state.build_initial_spectrum(
        config.map_size, p.spectrum_seed, p.tile_length, alpha, omega_p,
        p.wind_speed, angle, config.depth, p.swell, p.detail, p.spread, config.g,
        y_offset=y_offset, rows=rows)


def generate_spectrum_one(config: SimConfig, p: CascadeParams, y_offset: int = 0,
                          rows: int | None = None):
    """(h0, h0nc) planes, each (2, rows, N) ((2, N, N) by default), for ONE
    cascade — the dirty-only regeneration granularity
    (wave_generator.gd:67-72) and a row shard's block."""
    h0, h0nc = _spectrum_one(config, p, y_offset, rows)
    return (torch.stack([h0.real, h0.imag]), torch.stack([h0nc.real, h0nc.imag]))


def generate_spectrum(config: SimConfig, params: CascadeParams):
    """(h0, h0nc) fp32 plane pairs, each (C, 2, N, N)."""
    planes = [generate_spectrum_one(config, params.map(lambda x, i=i: x[i]))
              for i in range(params.num_cascades)]
    return (torch.stack([a for a, _ in planes]), torch.stack([b for _, b in planes]))


def generate_omega(config: SimConfig, params: CascadeParams,
                   indices: Sequence[int] | None = None) -> torch.Tensor:
    """Host-exact dispersion planes (C or len(indices), N, N) fp32 on the
    params' device (spectra.dispersion_grid_host)."""
    tiles = params.tile_length.detach().cpu().numpy().astype(np.float32)
    idxs = range(tiles.shape[0]) if indices is None else indices
    planes = np.stack([spectra.dispersion_grid_host(config.map_size, tiles[int(i)],
                                                    config.depth, config.g)
                       for i in idxs])
    return torch.from_numpy(planes).to(params.device)


def init_state(config: SimConfig, params: CascadeParams) -> OceanState:
    """Fresh state on the params' device: generated spectra, zero foam,
    staggered time offsets."""
    h0, h0nc = generate_spectrum(config, params)
    c, n, dev = params.num_cascades, config.map_size, params.device
    time = TIME_OFFSET_BASE + TIME_OFFSET_STEP * torch.arange(c, dtype=torch.float32, device=dev)
    return OceanState(h0=h0, h0nc=h0nc, omega=generate_omega(config, params),
                      foam=torch.zeros((c, n, n), dtype=torch.float32, device=dev),
                      time=time)


def _foam_rates(p: CascadeParams, dt):
    grow = dt * p.foam_amount * 7.5
    decay = dt * torch.clamp_min(10.0 - p.foam_amount, 0.5) * 1.15
    return grow, decay


def ifft2_layers(layers: torch.Tensor, fold_sign: bool, map_size: int) -> torch.Tensor:
    """The 2D IFFT of (..., 2, N, N) layer planes: the planes kernel on a
    CUDA device where it covers map_size, `torch.fft` elsewhere and on the
    CPU."""
    flat = layers.reshape((-1,) + layers.shape[-3:])
    fn = (planes_fft.ifft2_packed_planes if planes_fft.covers(map_size)
          else fft.ifft2_packed_planes)
    return fn(flat, fold_sign=fold_sign).reshape(layers.shape)


def _synthesize(config: SimConfig, h0, h0nc, omega, foam, p: CascadeParams, t, dt):
    """Maps + new foam for the cascades of `p` at modulation time `t`."""
    grow, decay = _foam_rates(p, dt)
    map_dtype = config.resolved_map_dtype()
    tier = config.step_tier()
    if tier != "staged":
        scal = fused_step.pack_scalars(t, p.tile_length, p.whitecap, grow, decay)
        kernel_step = (fused_step.fused_cascade_step if tier == "fused"
                       else strip_step.strip_cascade_step)
        return kernel_step(h0, h0nc, omega, foam, scal, map_dtype=map_dtype)
    layers = modulate_ops.modulate_planes(h0, h0nc, p.tile_length, config.depth, t,
                                          config.g, omega=omega)
    fields = ifft2_layers(layers, config.fold_sign, config.map_size)
    col = lambda x: x[:, None, None]
    return unpack_ops.unpack_planes(fields, foam, col(p.whitecap), col(grow), col(decay),
                                    pre_shifted=config.fold_sign, map_dtype=map_dtype)


def step(config: SimConfig, state: OceanState, params: CascadeParams, dt
         ) -> tuple[OceanState, OceanMaps]:
    """Advance every cascade by dt and synthesize maps. Time advances before
    modulation (wave_generator.gd:101-103), in fp32."""
    dt = _f32(dt)
    t_new = state.time + dt
    disp, normal, foam = _synthesize(config, state.h0, state.h0nc, state.omega,
                                     state.foam, params, t_new, dt)
    return state.replace(foam=foam, time=t_new), OceanMaps(displacement=disp, normal=normal)


def step_frames(config: SimConfig, state: OceanState, params: CascadeParams, dt,
                num_frames: int) -> tuple[OceanState, OceanMaps]:
    """`num_frames` consecutive frames; maps carry a per-frame axis (C, K, ...).

    Fused tier: frame k modulates at t0 + k*dt with t0 = time + dt, and the
    final time is time + dt*K (the multi-frame kernel's semantics). Strip
    and staged tiers: a loop of `step`.
    """
    dt = _f32(dt)
    if config.use_fused_step() and num_frames > 1:
        grow, decay = _foam_rates(params, dt)
        scal = fused_step.pack_scalars(state.time + dt, params.tile_length,
                                       params.whitecap, grow, decay, dt=dt)
        disp, normal, foam = fused_step.fused_cascade_multi_step(
            state.h0, state.h0nc, state.omega, state.foam, scal,
            num_frames=num_frames, map_dtype=config.resolved_map_dtype())
        new_state = state.replace(foam=foam, time=state.time + dt * num_frames)
        return new_state, OceanMaps(displacement=disp, normal=normal)
    frames = []
    for _ in range(num_frames):
        state, maps = step(config, state, params, dt)
        frames.append(maps)
    return state, OceanMaps(
        displacement=torch.stack([m.displacement for m in frames], dim=1),
        normal=torch.stack([m.normal for m in frames], dim=1))


def multi_step(config: SimConfig, state: OceanState, params: CascadeParams, dt,
               num_steps: int) -> tuple[OceanState, OceanMaps]:
    """`num_steps` frames; returns the final state and the LAST frame's maps."""
    if config.use_fused_step() and num_steps > 1:
        state, stacked = step_frames(config, state, params, dt, num_steps)
        return state, OceanMaps(displacement=stacked.displacement[:, -1],
                                normal=stacked.normal[:, -1])
    maps = None
    for _ in range(num_steps):
        state, maps = step(config, state, params, dt)
    return state, maps


def refresh_cascades(config: SimConfig, state: OceanState, params: CascadeParams,
                     dt, indices) -> tuple[OceanState, torch.Tensor, torch.Tensor]:
    """Refresh maps/foam for cascades `indices` at the CURRENT state.time.

    No time advance: the reference advances time once per update() for all
    cascades (wave_generator.gd:100-103), then refreshes cascades one per
    rendered frame at that time (wave_generator.gd:56-63). `dt` only sets the
    foam rates (wave_generator.gd:104-106). Returns (state with updated foam,
    displacement (K,3,N,N), normal (K,4,N,N)).
    """
    dev = state.time.device
    dt = _f32(dt)
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=dev)
    p = params.map(lambda x: x[idx])
    d, nm, foam_sub = _synthesize(config, state.h0[idx], state.h0nc[idx], state.omega[idx],
                                  state.foam[idx], p, state.time[idx], dt)
    foam = state.foam.clone()
    foam[idx] = foam_sub
    return state.replace(foam=foam), d, nm


def step_cascade(config: SimConfig, state: OceanState, params: CascadeParams, dt,
                 cascade_index: int) -> tuple[OceanState, OceanMaps]:
    """Update a SINGLE cascade's maps (one cascade per rendered frame,
    wave_generator.gd:56-63). Time advances for all cascades; maps of the
    other cascades are zeros."""
    dt = _f32(dt)
    state = state.replace(time=state.time + dt)
    i = int(cascade_index)
    new_state, d, nm = refresh_cascades(config, state, params, dt, [i])
    c, n = state.foam.shape[0], config.map_size
    dtype, dev = config.resolved_map_dtype(), state.foam.device
    disp = torch.zeros((c, 3, n, n), dtype=dtype, device=dev)
    normal = torch.zeros((c, 4, n, n), dtype=dtype, device=dev)
    disp[i] = d[0]
    normal[i] = nm[0]
    return new_state, OceanMaps(displacement=disp, normal=normal)


def simulate(config: SimConfig, state: OceanState, params: CascadeParams, dt,
             num_steps: int) -> tuple[OceanState, OceanMaps]:
    """Time-batched rollout (foam is a recurrence, so a loop); maps stacked
    on a leading time axis (T, C, ...)."""
    frames = []
    for _ in range(num_steps):
        state, maps = step(config, state, params, dt)
        frames.append(maps)
    return state, OceanMaps(
        displacement=torch.stack([m.displacement for m in frames]),
        normal=torch.stack([m.normal for m in frames]))


def _zero_maps(config: SimConfig, c: int, device) -> OceanMaps:
    n, dtype = config.map_size, config.resolved_map_dtype()
    return OceanMaps(
        displacement=torch.zeros((c, 3, n, n), dtype=dtype, device=device),
        normal=torch.zeros((c, 4, n, n), dtype=dtype, device=device))


class Ocean:
    """Host-side session: the `Water` orchestrator (water.gd).

    Manages the parameter set with dirty-bit spectrum regeneration, the
    updates_per_second scheduler and (optionally) cascade staggering.
    `device` defaults to "cuda" and is never silently replaced.

    >>> ocean = Ocean(map_size=256, device="cuda")
    >>> maps = ocean.update(1 / 60)          # None on skipped frames
    >>> ocean.set_cascade(0, wind_speed=15)  # marks cascade 0 dirty
    """

    def __init__(
        self,
        params: CascadeParams | Sequence[CascadeParams] | None = None,
        map_size: int = 1024,
        updates_per_second: float = 50.0,
        stagger: bool = False,
        device: torch.device | str = "cuda",
        **config_kwargs: Any,
    ):
        self.device = require_device(device)
        if params is None:
            params = default_cascades(device=self.device)
        elif isinstance(params, (list, tuple)):
            params = stack_cascades(params)
        self.config = SimConfig(map_size=map_size, **config_kwargs)
        self.params = params.to(self.device)
        # Global water/foam colours (water.gd:14-18): project-wide shader
        # globals in the reference (project.godot:60-81); the session owns the
        # one copy every render surface reads. Linear RGB, host NumPy.
        self.water_color = np.asarray(shading.DEFAULT_WATER_COLOR, np.float32)
        self.foam_color = np.asarray(shading.DEFAULT_FOAM_COLOR, np.float32)
        # session RNG for runtime cascade re-seeding (water.gd:68-69, seed 1234)
        self._rng = np.random.RandomState(1234)
        self._time = 0.0
        self._next_update_time = 0.0
        self.updates_per_second = updates_per_second
        self.stagger = stagger
        self.state = init_state(self.config, self.params)
        self._dirty = np.zeros(self.params.num_cascades, bool)
        self._pending: list[int] = []   # cascades awaiting refresh this round
        self._round_dt = 0.0            # the armed round's foam-rate dt
        self.maps = _zero_maps(self.config, self.num_cascades, self.device)

    @property
    def num_cascades(self) -> int:
        return self.params.num_cascades

    @property
    def updates_per_second(self) -> float:
        return self._updates_per_second

    @updates_per_second.setter
    def updates_per_second(self, value: float) -> None:
        """Rebase the in-flight schedule so a rate change takes effect
        immediately (water.gd:51-54: next_update_time -= 1/old - 1/new)."""
        old = getattr(self, "_updates_per_second", value)
        self._next_update_time -= 1.0 / (old + 1e-10) - 1.0 / (value + 1e-10)
        self._updates_per_second = value

    # --- parameter editing (main.gd:92-108) ---

    _SPECTRUM_FIELDS = frozenset({
        "tile_length", "wind_speed", "wind_direction", "fetch_length",
        "swell", "spread", "detail", "whitecap", "foam_amount", "spectrum_seed",
    })  # the setters that flip should_generate_spectrum (wave_cascade_parameters.gd:7-35)

    def set_cascade(self, index: int, **updates: Any) -> None:
        """Update one cascade's parameters; spectrum-affecting fields mark it
        dirty so h0 regenerates on the next update."""
        new = {}
        for name, value in updates.items():
            field = getattr(self.params, name)
            if name == "tile_length" and isinstance(value, (int, float)):
                value = (float(value), float(value))
            if name in ("wind_speed", "fetch_length"):
                value = max(1e-4, float(value))
            updated = field.clone()
            updated[index] = torch.as_tensor(value, dtype=field.dtype, device=field.device)
            new[name] = updated
            if name in self._SPECTRUM_FIELDS:
                self._dirty[index] = True
        self.params = self.params.replace(**new)

    def set_cascades(self, params: CascadeParams | Sequence[CascadeParams],
                     reseed: bool = True) -> None:
        """Replace the whole cascade stack at runtime (add/remove cascades).

        The reference's `parameters` setter (water.gd:22-35): every cascade
        draws a fresh spectrum seed from the session RNG and restarts at
        time 120 + pi*i (water.gd:31-32); spectra, foam and map buffers
        rebuild. reseed=False keeps the given seeds (times still restart).
        """
        if isinstance(params, (list, tuple)):
            params = stack_cascades(params)
        params = params.to(self.device)
        c = params.num_cascades
        if reseed:
            seeds = self._rng.randint(-10000, 10001, (c, 2))
            params = params.replace(spectrum_seed=torch.as_tensor(
                seeds, dtype=torch.int32, device=self.device))
        self.params = params
        self.state = init_state(self.config, params)
        self._dirty = np.zeros(c, bool)
        self._pending = []
        self.maps = _zero_maps(self.config, c, self.device)

    def regenerate_dirty(self) -> None:
        """Re-run spectrum generation for DIRTY cascades only
        (wave_generator.gd:67-72). Writes new buffers: the state a step may
        still be reading is never modified."""
        idxs = np.nonzero(self._dirty)[0]
        if idxs.size == 0:
            return
        if idxs.size == self.num_cascades:
            h0, h0nc = generate_spectrum(self.config, self.params)
            omega = generate_omega(self.config, self.params)
        else:
            h0, h0nc = self.state.h0.clone(), self.state.h0nc.clone()
            omega = self.state.omega.clone()
            for i in idxs:
                p = self.params.map(lambda x, i=int(i): x[i])
                h0[int(i)], h0nc[int(i)] = generate_spectrum_one(self.config, p)
            # omega tracks tile_length edits; one host plane per dirty cascade
            omega[torch.as_tensor(idxs, device=self.device)] = generate_omega(
                self.config, self.params, idxs)
        self.state = self.state.replace(h0=h0, h0nc=h0nc, omega=omega)
        self._dirty[:] = False

    # --- per-frame driving (water.gd:75-82 scheduler semantics) ---

    def update(self, delta: float) -> OceanMaps | None:
        """Advance wall time by `delta`; run a simulation update if due.

        Returns the maps whenever they changed this frame, else None. Skipped
        time is folded into the next update's dt (water.gd:77-80). In stagger
        mode, frames between updates each refresh ONE pending cascade.
        """
        ups = self.updates_per_second
        ran = None
        if ups == 0 or self._time >= self._next_update_time:
            target = 1.0 / (ups + 1e-10)
            update_delta = delta if ups == 0 else target + (self._time - self._next_update_time)
            self._next_update_time = self._time + target
            ran = self._update_water(update_delta)
        elif self.stagger and self._pending:
            self._refresh([self._pending.pop(0)], self._round_dt)
            ran = self.maps
        self._time += delta
        return ran

    def _update_water(self, dt: float) -> OceanMaps:
        self.regenerate_dirty()
        if not self.stagger:
            self.state, self.maps = step(self.config, self.state, self.params, dt)
            return self.maps
        # Catch-up flush: cascades the previous round hasn't refreshed go
        # through in ONE dispatch before the new round arms
        # (wave_generator.gd:90-98), at the previous round's foam dt.
        if self._pending:
            self._refresh(self._pending, self._round_dt)
        # Arm the new round: advance time ONCE for all cascades
        # (wave_generator.gd:100-103); refreshes then happen at this time.
        self.state = self.state.replace(time=self.state.time + _f32(dt))
        self._round_dt = dt
        self._pending = list(range(self.num_cascades))
        self._refresh([self._pending.pop(0)], dt)
        return self.maps

    def _refresh(self, indices: Sequence[int], dt: float) -> None:
        """Refresh `indices`' maps/foam and composite into the persistent map
        buffers (new tensors; earlier returned maps stay valid)."""
        self.state, d, nm = refresh_cascades(self.config, self.state, self.params,
                                             dt, indices)
        idx = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        disp, normal = self.maps.displacement.clone(), self.maps.normal.clone()
        disp[idx] = d
        normal[idx] = nm
        self.maps = OceanMaps(displacement=disp, normal=normal)

    def resize(self, map_size: int, clear_jit_caches: bool = True) -> None:
        """Change the map resolution: full state rebuild, params preserved
        (the reference's map_size setter, water.gd:38-41).

        `clear_jit_caches` is accepted for the JAX package's callers and
        ignored: PyTorch runs eagerly and keeps no compiled executables
        per shape.
        """
        self.config = dataclasses.replace(self.config, map_size=map_size)
        self.state = init_state(self.config, self.params)
        self._dirty[:] = False
        self._pending = []
        self.maps = _zero_maps(self.config, self.num_cascades, self.device)

    # --- checkpoint / resume (SURVEY.md section 5.4) ---

    def checkpoint(self) -> dict[str, Any]:
        """Snapshot of all cross-frame state: the state and params as CPU
        tensors (the fp32 planes as they are; no complex leaves), the
        scheduler and the colours."""
        from ..utils.hostio import device_get_tree
        return {
            "map_size": self.config.map_size,
            "num_cascades": self.num_cascades,
            "state": device_get_tree(self.state),
            "params": device_get_tree(self.params),
            "time": self._time,
            "next_update_time": self._next_update_time,
            "pending": list(self._pending),
            "round_dt": self._round_dt,
            "water_color": [float(v) for v in self.water_color],
            "foam_color": [float(v) for v in self.foam_color],
        }

    def restore(self, snapshot: dict[str, Any]) -> None:
        """Restore a `checkpoint()` snapshot onto this session's device.

        Raises if the cascade count differs; resizes if the map size does.
        The persistent map buffers reset to zeros.
        """
        from ..utils.hostio import device_put_tree
        size = snapshot.get("map_size", self.config.map_size)
        cascades = snapshot.get("num_cascades", self.num_cascades)
        if cascades != self.num_cascades:
            raise ValueError(
                f"snapshot has {cascades} cascades, session has "
                f"{self.num_cascades}; rebuild the Ocean with matching params")
        if size != self.config.map_size:
            self.resize(size)
        self.state = device_put_tree(snapshot["state"], self.device)
        self.params = device_put_tree(snapshot["params"], self.device)
        self._time = snapshot["time"]
        self._next_update_time = snapshot["next_update_time"]
        self._pending = list(snapshot.get("pending", []))
        self._round_dt = snapshot.get("round_dt", 0.0)
        if "water_color" in snapshot:
            self.water_color = np.asarray(snapshot["water_color"], np.float32)
        if "foam_color" in snapshot:
            self.foam_color = np.asarray(snapshot["foam_color"], np.float32)
        self._dirty[:] = False
        self.maps = _zero_maps(self.config, self.num_cascades, self.device)
