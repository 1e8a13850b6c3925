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

A session may give each cascade a map size of its own
(`Ocean(map_size=(1024, 256, 64))`, BASELINE config 3). Cascades of one
size form a group, in the order the size first appears (`Ocean.groups`),
with its own `SimConfig`, `OceanState` and params slice, and each update
runs `step` once a group at the same dt, under the one session clock:
cascade i starts at 120 + pi*i by its index in the session. `config`,
`state` and `maps` are then tuples, one entry a group. A session whose
cascades share one size is built as before and runs the same calls; which
of the two a session is gets decided when it is built (`__init__`,
`resize`, `set_cascades`), never in an update. On the card a mixed
session records each group's `step` on K1 or K4 as a CUDA graph at its
first update (`_GroupGraph`) and replays it after, bit for bit what the
eager `step` gives. Consumers of stacked (C, ..., N, N) maps refuse a mixed session
(`require_one_size`).

Spans (`utils/observability.py`): `ocean.update` around every call,
`ocean.regenerate` while a dirty cascade regenerates, `ocean.step` around a
step's whole issue, and inside it `step.scalars` (the foam rates and the
kernels' packed scalars) or `step.staged` (the staged tier's modules); in a
mixed session `ocean.step_group` around each group's `step` or replay,
inside `ocean.step`, and `graph.capture` while a group's graph records.
Counters: `ocean.skipped` (the rate limiter returned None),
`ocean.regenerated` (cascades) and `ocean.step_groups` (a mixed session's
groups stepped).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..ops import fft, fused_step, initial_state, planes_fft, spectra, strip_step
from ..ops import modulate as modulate_ops, unpack as unpack_ops
from ..utils import graphs
from ..utils.observability import count, span
from . import shading
from .cascade import (CascadeParams, SimConfig, default_cascades, require_device,
                      size_groups, stack_cascades)

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


def init_state(config: SimConfig, params: CascadeParams,
               indices: Sequence[int] | None = None) -> OceanState:
    """Fresh state on the params' device: generated spectra, zero foam,
    staggered time offsets. Cascade k starts at 120 + pi*i, with i its index
    in the session: `indices[k]` (a size group's), k by default."""
    h0, h0nc = generate_spectrum(config, params)
    c, n, dev = params.num_cascades, config.map_size, params.device
    at = (torch.arange(c, dtype=torch.float32, device=dev) if indices is None
          else torch.tensor(list(indices), dtype=torch.float32, device=dev))
    time = TIME_OFFSET_BASE + TIME_OFFSET_STEP * at
    return OceanState(h0=h0, h0nc=h0nc, omega=generate_omega(config, params),
                      foam=torch.zeros((c, n, n), dtype=torch.float32, device=dev),
                      time=time)


def _regenerated(config: SimConfig, state: OceanState, params: CascadeParams,
                 indices) -> OceanState:
    """`state` with the spectra and omega of cascades `indices` generated
    anew from `params` (all of them at once where `indices` names every
    cascade). Writes new buffers: the state a step may still be reading is
    never modified."""
    if len(indices) == params.num_cascades:
        h0, h0nc = generate_spectrum(config, params)
        omega = generate_omega(config, params)
    else:
        h0, h0nc = state.h0.clone(), state.h0nc.clone()
        omega = state.omega.clone()
        for i in indices:
            p = params.map(lambda x, i=int(i): x[i])
            h0[int(i)], h0nc[int(i)] = generate_spectrum_one(config, p)
        # omega tracks tile_length edits; one host plane per dirty cascade
        omega[torch.as_tensor(np.asarray(indices, np.int64), device=omega.device)] = \
            generate_omega(config, params, indices)
    return state.replace(h0=h0, h0nc=h0nc, omega=omega)


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
    map_dtype = config.resolved_map_dtype()
    tier = config.step_tier()
    with span("step.scalars"):
        grow, decay = _foam_rates(p, dt)
        if tier != "staged":
            scal = fused_step.pack_scalars(t, p.tile_length, p.whitecap, grow, decay)
    if tier != "staged":
        kernel_step = (fused_step.fused_cascade_step if tier == "fused"
                       else strip_step.strip_cascade_step)
        return kernel_step(h0, h0nc, omega, foam, scal, map_dtype=map_dtype)
    with span("step.staged"):
        layers = modulate_ops.modulate_planes(h0, h0nc, p.tile_length, config.depth, t,
                                              config.g, omega=omega)
        fields = ifft2_layers(layers, config.fold_sign, config.map_size)
        col = lambda x: x[:, None, None]
        return unpack_ops.unpack_planes(fields, foam, col(p.whitecap), col(grow),
                                        col(decay), pre_shifted=config.fold_sign,
                                        map_dtype=map_dtype)


def step(config: SimConfig, state: OceanState, params: CascadeParams, dt
         ) -> tuple[OceanState, OceanMaps]:
    """Advance every cascade by dt and synthesize maps. Time advances before
    modulation (wave_generator.gd:101-103), in fp32."""
    dt = _f32(dt)
    t_new = state.time + dt
    disp, normal, foam = _synthesize(config, state.h0, state.h0nc, state.omega,
                                     state.foam, params, t_new, dt)
    return state.replace(foam=foam, time=t_new), OceanMaps(displacement=disp, normal=normal)


def _step_loop(config: SimConfig, state: OceanState, params: CascadeParams, dt,
               num_steps: int, stack_dim: int | None) -> tuple[OceanState, OceanMaps | None]:
    """`num_steps` calls of `step`: the final state and the maps stacked on
    `stack_dim`, or the last frame's maps (None after 0 steps) where it is None."""
    frames = []
    for _ in range(num_steps):
        state, maps = step(config, state, params, dt)
        if stack_dim is None:
            frames.clear()                  # only the last frame's maps are kept
        frames.append(maps)
    if stack_dim is None:
        return state, frames[-1] if frames else None
    return state, OceanMaps(
        displacement=torch.stack([m.displacement for m in frames], dim=stack_dim),
        normal=torch.stack([m.normal for m in frames], dim=stack_dim))


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
    return _step_loop(config, state, params, dt, num_frames, stack_dim=1)


def multi_step(config: SimConfig, state: OceanState, params: CascadeParams, dt,
               num_steps: int) -> tuple[OceanState, OceanMaps]:
    """`num_steps` frames; returns the final state and the LAST frame's maps."""
    if config.use_fused_step() and num_steps > 1:
        state, stacked = step_frames(config, state, params, dt, num_steps)
        return state, OceanMaps(displacement=stacked.displacement[:, -1],
                                normal=stacked.normal[:, -1])
    return _step_loop(config, state, params, dt, num_steps, stack_dim=None)


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
    return _step_loop(config, state, params, dt, num_steps, stack_dim=0)


def _zero_maps(config: SimConfig, c: int, device) -> OceanMaps:
    n, dtype = config.map_size, config.resolved_map_dtype()
    return OceanMaps(
        displacement=torch.zeros((c, 3, n, n), dtype=dtype, device=device),
        normal=torch.zeros((c, 4, n, n), dtype=dtype, device=device))


class _GroupGraph:
    """One size group's `step` as a CUDA graph, for a mixed session on the card.

    Recorded from the state an eager `step` has just returned, so that the
    caches it reads are filled. The graph reads the group's spectra, omega
    and params slice where they are, dt from the session's one-element
    buffer, and the foam and time from buffers of its own, which each replay
    advances in place. A replay hands out copies, fresh tensors as `step`'s
    are: the maps a caller holds stay as they were. A state whose foam or
    time is not the one the last replay handed out (a restore, a stagger
    round) is copied in first; one with other spectra, omega or params
    (`fits`) needs a new recording. A state's tensors are replaced, never
    edited in place: an in-place edit of the foam handed out is not seen.
    """

    def __init__(self, config: SimConfig, state: OceanState, params: CascadeParams,
                 dt: torch.Tensor):
        self.inputs = (state.h0, state.h0nc, state.omega, params)
        self.foam, self.time = state.foam.clone(), state.time.clone()
        self.handed = (state.foam, state.time)

        def advance() -> OceanMaps:
            new, maps = step(config, state.replace(foam=self.foam, time=self.time), params, dt)
            self.foam.copy_(new.foam)
            self.time.copy_(new.time)
            return maps

        self.recording = graphs.Recording(advance)

    def fits(self, state: OceanState, params: CascadeParams) -> bool:
        h0, h0nc, omega, p = self.inputs
        return (state.h0 is h0 and state.h0nc is h0nc and state.omega is omega
                and params is p)

    def __call__(self, state: OceanState) -> tuple[OceanState, OceanMaps]:
        if state.foam is not self.handed[0]:
            self.foam.copy_(state.foam)
        if state.time is not self.handed[1]:
            self.time.copy_(state.time)
        self.recording.replay()
        maps = self.recording.outputs
        foam, time = self.foam.clone(), self.time.clone()
        self.handed = (foam, time)
        return (OceanState(h0=state.h0, h0nc=state.h0nc, omega=state.omega, foam=foam,
                           time=time),
                OceanMaps(displacement=maps.displacement.clone(), normal=maps.normal.clone()))


def _group_size(value) -> int:
    """The map size of one size group's `SimConfig`, `OceanState` or `OceanMaps`."""
    if isinstance(value, SimConfig):
        return value.map_size
    return int((value.foam if isinstance(value, OceanState) else value.displacement).shape[-1])


def require_one_size(value, consumer: str) -> None:
    """Raise ValueError where `value` comes from a mixed-size session: an
    `Ocean` whose cascades differ in map size, or such a session's `maps`,
    `state` or `config` (a tuple, one entry a size group). The message names
    `consumer` and the sizes. Every consumer of stacked (C, ..., N, N) maps
    calls it on what it is handed."""
    if isinstance(value, Ocean):
        if len(value.groups) == 1:
            return
        sizes = value.map_sizes
    elif isinstance(value, (tuple, list)):
        sizes = tuple(_group_size(v) for v in value)
    else:
        return
    raise ValueError(f"{consumer} takes cascades of one map size, stacked (C, ..., N, N); "
                     f"this session's map sizes are {', '.join(f'{n}x{n}' for n in sizes)}")


class Ocean:
    """Host-side session: the `Water` orchestrator (water.gd).

    Manages the parameter set with dirty-bit spectrum regeneration, the
    updates_per_second scheduler and (optionally) cascade staggering.
    `device` defaults to "cuda" and is never silently replaced.

    `map_size` is one size for every cascade, or a sequence of one size a
    cascade: cascades of equal size then form a group (`groups`) with its
    own `SimConfig`, `OceanState`, params slice and `OceanMaps`, and
    `config`, `state` and `maps` are tuples in group order (see the module
    docstring). Equal sizes build the one-size session.

    >>> ocean = Ocean(map_size=256, device="cuda")
    >>> maps = ocean.update(1 / 60)          # None on skipped frames
    >>> ocean.set_cascade(0, wind_speed=15)  # marks cascade 0 dirty
    >>> mixed = Ocean(map_size=(1024, 256, 64), device="cuda")
    >>> big, mid, small = mixed.update(1 / 50)   # one OceanMaps a size group
    """

    # A mixed session's forms of the methods an update runs, bound on the
    # instance in place of the one-size forms when the session is built
    # (`_build`), so that a one-size update runs no test of which it is.
    _GROUP_FORMS = {"_update_water": "_update_groups", "_refresh": "_refresh_groups"}

    def __init__(
        self,
        params: CascadeParams | Sequence[CascadeParams] | None = None,
        map_size: int | Sequence[int] = 1024,
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
        groups = size_groups(map_size, params.num_cascades)
        self.config = SimConfig(map_size=groups[0][0], **config_kwargs)
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
        self._dirty = np.zeros(self.params.num_cascades, bool)
        self._pending: list[int] = []   # cascades awaiting refresh this round
        self._round_dt = 0.0            # the armed round's foam-rate dt
        self._build(groups)

    def _build(self, groups) -> None:
        """Config, fresh state and zero map buffers for the size groups
        `groups` (`size_groups`); the config's other fields carry over. One
        group builds the one-size session; more bind the group forms
        (`_GROUP_FORMS`)."""
        base = self.config if isinstance(self.config, SimConfig) else self.config[0]
        self._groups = groups
        self._graphs = []               # a mixed session's recordings, one a group
        if len(groups) == 1:
            self.config = dataclasses.replace(base, map_size=groups[0][0])
            self.state = init_state(self.config, self.params)
            self.maps = _zero_maps(self.config, self.num_cascades, self.device)
            self._group_params = None
            for name in self._GROUP_FORMS:
                self.__dict__.pop(name, None)
            return
        self.config = tuple(dataclasses.replace(base, map_size=n) for n, _ in groups)
        self._group_params = self._params_by_group()
        self.state = tuple(init_state(c, p, idx) for c, p, (_, idx)
                           in zip(self.config, self._group_params, groups))
        self.maps = tuple(_zero_maps(c, len(idx), self.device)
                          for c, (_, idx) in zip(self.config, groups))
        self._graphs = [None] * len(groups)    # recorded at each group's first update
        self._dt = torch.zeros((), dtype=torch.float32, device=self.device)
        self._dt_value = None
        for name, form in self._GROUP_FORMS.items():
            setattr(self, name, getattr(self, form))

    def _params_by_group(self, cascade: int | None = None) -> tuple[CascadeParams, ...]:
        """Each group's slice of `params`; with `cascade`, only the slice of
        its group is cut anew and the others are kept, so their graphs still
        fit (`_GroupGraph.fits`)."""
        out = []
        for g, (_, idx) in enumerate(self._groups):
            if cascade is not None and cascade not in idx:
                out.append(self._group_params[g])
                continue
            at = torch.as_tensor(idx, device=self.device)
            out.append(self.params.map(lambda x: x[at]))
        return tuple(out)

    @property
    def num_cascades(self) -> int:
        return self.params.num_cascades

    @property
    def groups(self) -> tuple[tuple[int, tuple[int, ...]], ...]:
        """The size groups, ((map_size, cascade indices), ...): one for a
        one-size session."""
        return self._groups

    @property
    def map_sizes(self) -> tuple[int, ...]:
        """Each cascade's map size, by cascade index."""
        sizes = [0] * self.num_cascades
        for n, idx in self._groups:
            for i in idx:
                sizes[i] = n
        return tuple(sizes)

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
        if self._group_params is not None:
            self._group_params = self._params_by_group(index)

    def set_cascades(self, params: CascadeParams | Sequence[CascadeParams],
                     reseed: bool = True) -> None:
        """Replace the whole cascade stack at runtime (add/remove cascades).

        The reference's `parameters` setter (water.gd:22-35): every cascade
        draws a fresh spectrum seed from the session RNG and restarts at
        time 120 + pi*i (water.gd:31-32); spectra, foam and map buffers
        rebuild. reseed=False keeps the given seeds (times still restart).
        A one-size session keeps its size; a mixed one keeps each cascade's
        (the new stack must have as many cascades; `resize` first to change
        the count).
        """
        if isinstance(params, (list, tuple)):
            params = stack_cascades(params)
        params = params.to(self.device)
        c = params.num_cascades
        groups = size_groups(self._groups[0][0] if len(self._groups) == 1 else self.map_sizes, c)
        if reseed:
            seeds = self._rng.randint(-10000, 10001, (c, 2))
            params = params.replace(spectrum_seed=torch.as_tensor(
                seeds, dtype=torch.int32, device=self.device))
        self.params = params
        self._dirty = np.zeros(c, bool)
        self._pending = []
        self._build(groups)

    def regenerate_dirty(self) -> None:
        """Re-run spectrum generation for DIRTY cascades only
        (wave_generator.gd:67-72), a size group at a time in a mixed
        session. Writes new buffers: the state a step may still be reading
        is never modified."""
        idxs = np.nonzero(self._dirty)[0]
        if idxs.size == 0:
            return
        count("ocean.regenerated", int(idxs.size))
        with span("ocean.regenerate"):
            if self._group_params is None:
                self.state = _regenerated(self.config, self.state, self.params, idxs)
            else:
                states = list(self.state)
                for g, (_, members) in enumerate(self._groups):
                    local = [k for k, i in enumerate(members) if self._dirty[i]]
                    if local:
                        states[g] = _regenerated(self.config[g], states[g],
                                                 self._group_params[g], local)
                self.state = tuple(states)
            self._dirty[:] = False

    # --- per-frame driving (water.gd:75-82 scheduler semantics) ---

    def update(self, delta: float) -> OceanMaps | None:
        """Advance wall time by `delta`; run a simulation update if due.

        Returns the maps whenever they changed this frame, else None. Skipped
        time is folded into the next update's dt (water.gd:77-80). In stagger
        mode, frames between updates each refresh ONE pending cascade.
        """
        with span("ocean.update"):
            ups = self.updates_per_second
            ran = None
            if ups == 0 or self._time >= self._next_update_time:
                target = 1.0 / (ups + 1e-10)
                update_delta = (delta if ups == 0
                                else target + (self._time - self._next_update_time))
                self._next_update_time = self._time + target
                ran = self._update_water(update_delta)
            elif self.stagger and self._pending:
                self._refresh([self._pending.pop(0)], self._round_dt)
                ran = self.maps
            else:
                count("ocean.skipped")
            self._time += delta
            return ran

    def _update_water(self, dt: float) -> OceanMaps:
        self.regenerate_dirty()
        if not self.stagger:
            with span("ocean.step"):
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
        with span("ocean.step"):
            self.state, d, nm = refresh_cascades(self.config, self.state, self.params,
                                                 dt, indices)
            idx = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
            disp, normal = self.maps.displacement.clone(), self.maps.normal.clone()
            disp[idx] = d
            normal[idx] = nm
            self.maps = OceanMaps(displacement=disp, normal=normal)

    def _update_groups(self, dt: float) -> tuple[OceanMaps, ...]:
        """`_update_water` of a mixed session: `step` on each size group at
        the same dt (stagger: the round's refreshes, each in its group)."""
        self.regenerate_dirty()
        if not self.stagger:
            with span("ocean.step"):
                states, maps = [], []
                for g, (config, state, params) in enumerate(
                        zip(self.config, self.state, self._group_params)):
                    count("ocean.step_groups")
                    with span("ocean.step_group"):
                        state, m = self._step_group(g, config, state, params, dt)
                    states.append(state)
                    maps.append(m)
                self.state, self.maps = tuple(states), tuple(maps)
            return self.maps
        if self._pending:
            self._refresh(self._pending, self._round_dt)
        self.state = tuple(s.replace(time=s.time + _f32(dt)) for s in self.state)
        self._round_dt = dt
        self._pending = list(range(self.num_cascades))
        self._refresh([self._pending.pop(0)], dt)
        return self.maps

    def _step_group(self, g: int, config: SimConfig, state: OceanState,
                    params: CascadeParams, dt: float) -> tuple[OceanState, OceanMaps]:
        """`step` of size group `g`: its graph's replay where the graph fits
        the group's state and params, else an eager `step`, after which a
        group on the card records its graph (`_GroupGraph`) for the next
        update. Not on the card, inside `graphs.disabled()`, or on the staged
        tier (`fused="never"`, whose modules do not record), always eager."""
        graph = self._graphs[g]
        if graph is not None and graphs.enabled() and graph.fits(state, params):
            dt = _f32(dt)
            if dt != self._dt_value:
                self._dt.fill_(dt)
                self._dt_value = dt
            return graph(state)
        state, maps = step(config, state, params, dt)
        if state.foam.is_cuda and graphs.enabled() and config.step_tier() != "staged":
            self._graphs[g] = None      # the old recording's pool goes before the new one's
            self._graphs[g] = _GroupGraph(config, state, params, self._dt)
        return state, maps

    def _refresh_groups(self, indices: Sequence[int], dt: float) -> None:
        """`_refresh` of a mixed session: each group refreshes its cascades
        among `indices` into its own map buffers."""
        with span("ocean.step"):
            states, maps = list(self.state), list(self.maps)
            for g, (_, members) in enumerate(self._groups):
                local = [members.index(i) for i in indices if i in members]
                if not local:
                    continue
                states[g], d, nm = refresh_cascades(self.config[g], states[g],
                                                    self._group_params[g], dt, local)
                idx = torch.as_tensor(np.asarray(local, np.int64), device=self.device)
                disp, normal = maps[g].displacement.clone(), maps[g].normal.clone()
                disp[idx] = d
                normal[idx] = nm
                maps[g] = OceanMaps(displacement=disp, normal=normal)
            self.state, self.maps = tuple(states), tuple(maps)

    def resize(self, map_size: int | Sequence[int], clear_jit_caches: bool = True) -> None:
        """Change the map resolution: full state rebuild, params preserved
        (the reference's map_size setter, water.gd:38-41). A sequence gives
        one size a cascade, as in the constructor.

        `clear_jit_caches` is accepted for the JAX package's callers and
        ignored: PyTorch runs eagerly and keeps no compiled executables
        per shape.
        """
        self._build(size_groups(map_size, self.num_cascades))
        self._dirty[:] = False
        self._pending = []

    # --- checkpoint / resume (SURVEY.md section 5.4) ---

    def checkpoint(self) -> dict[str, Any]:
        """Snapshot of all cross-frame state: the state and params as CPU
        tensors (the fp32 planes as they are; no complex leaves), the
        scheduler and the colours. A mixed session's `map_size` is the list
        of each cascade's size and its `state` the tuple of its groups'."""
        from ..utils.hostio import device_get_tree
        return {
            "map_size": (self._groups[0][0] if len(self._groups) == 1
                         else list(self.map_sizes)),
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

        Raises if the cascade count differs; resizes if a map size does.
        The persistent map buffers reset to zeros.
        """
        from ..utils.hostio import device_put_tree
        size = snapshot.get("map_size")
        cascades = snapshot.get("num_cascades", self.num_cascades)
        if cascades != self.num_cascades:
            raise ValueError(
                f"snapshot has {cascades} cascades, session has "
                f"{self.num_cascades}; rebuild the Ocean with matching params")
        if size is not None and size_groups(size, self.num_cascades) != self._groups:
            self.resize(size)
        self.state = device_put_tree(snapshot["state"], self.device)
        self.params = device_put_tree(snapshot["params"], self.device)
        if self._group_params is not None:
            self._group_params = self._params_by_group()
        self._time = snapshot["time"]
        self._next_update_time = snapshot["next_update_time"]
        self._pending = list(snapshot.get("pending", []))
        self._round_dt = snapshot.get("round_dt", 0.0)
        if "water_color" in snapshot:
            self.water_color = np.asarray(snapshot["water_color"], np.float32)
        if "foam_color" in snapshot:
            self.foam_color = np.asarray(snapshot["foam_color"], np.float32)
        self._dirty[:] = False
        if self._group_params is None:
            self.maps = _zero_maps(self.config, self.num_cascades, self.device)
        else:
            self.maps = tuple(_zero_maps(c, len(idx), self.device)
                              for c, (_, idx) in zip(self.config, self._groups))
