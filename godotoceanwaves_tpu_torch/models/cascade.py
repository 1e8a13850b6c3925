"""Cascade parameter model + simulation config (PyTorch port).

Counterpart of `godotoceanwaves_tpu/models/cascade.py`. `CascadeParams` is a
plain dataclass of tensors (a single cascade, or a stack with a leading
cascade axis) with the same 12 fields, defaults and setter clamps as the
reference resource `WaveCascadeParameters`
(assets/water/wave_cascade_parameters.gd:7-35).

`SimConfig` keeps the static configuration and routes a step by map size,
as the JAX package's gates do (its cascade.py:199-249), with the card's
ranges: the fused kernel pair (`ops/fused_step.py`) for 16 <= N <= 1024, the
strip kernel pair (`ops/strip_step.py`) for 1024 < N <= 8192, and the staged
modules for every other N or with `fused="never"`. The JAX package's
`fft_impl` tiers (matmul / direct / fourstep) exist only because `jnp.fft`
is missing on the TPU; the staged path here runs the planes IFFT kernel
(`ops/planes_fft.py`) where it covers N, `torch.fft` elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from ..ops import fused_step, strip_step


def require_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; "cuda" with no CUDA device raises instead
    of running somewhere else. The entry points default to the card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA device and none is "
                           "available; pass device='cpu' explicitly to run on the CPU")
    return device


@dataclasses.dataclass
class CascadeParams:
    """One wave cascade's parameters (or a stack of them with a leading axis).

    Fields mirror wave_cascade_parameters.gd; `wind_direction` is degrees,
    `fetch_length` is kilometers (converted at dispatch, wave_generator.gd:69-71).
    """
    tile_length: torch.Tensor          # (..., 2) float32, meters
    displacement_scale: torch.Tensor   # float32 in [0, 2]
    normal_scale: torch.Tensor         # float32 in [0, 2]
    wind_speed: torch.Tensor           # float32, m/s (clamped >= 1e-4)
    wind_direction: torch.Tensor       # float32, degrees
    fetch_length: torch.Tensor         # float32, km (clamped >= 1e-4)
    swell: torch.Tensor                # float32 in [0, 2]
    spread: torch.Tensor               # float32 in [0, 1]
    detail: torch.Tensor               # float32 in [0, 1]
    whitecap: torch.Tensor             # float32 in [0, 2]
    foam_amount: torch.Tensor          # float32 in [0, 10]
    spectrum_seed: torch.Tensor        # (..., 2) int32

    @classmethod
    def create(
        cls,
        tile_length: tuple[float, float] | float = (50.0, 50.0),
        displacement_scale: float = 1.0,
        normal_scale: float = 1.0,
        wind_speed: float = 20.0,
        wind_direction: float = 0.0,
        fetch_length: float = 550.0,
        swell: float = 0.8,
        spread: float = 0.2,
        detail: float = 1.0,
        whitecap: float = 0.5,
        foam_amount: float = 5.0,
        spectrum_seed: tuple[int, int] = (0, 0),
        device: torch.device | str = "cuda",
    ) -> "CascadeParams":
        device = require_device(device)
        if isinstance(tile_length, (int, float)):
            tile_length = (float(tile_length), float(tile_length))
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return cls(
            tile_length=f32(tile_length),
            displacement_scale=f32(displacement_scale),
            normal_scale=f32(normal_scale),
            wind_speed=f32(max(1e-4, wind_speed)),       # setter clamp, gd:15
            wind_direction=f32(wind_direction),
            fetch_length=f32(max(1e-4, fetch_length)),   # setter clamp, gd:20
            swell=f32(swell),
            spread=f32(spread),
            detail=f32(detail),
            whitecap=f32(whitecap),
            foam_amount=f32(foam_amount),
            spectrum_seed=torch.tensor(spectrum_seed, dtype=torch.int32, device=device),
        )

    def replace(self, **changes) -> "CascadeParams":
        return dataclasses.replace(self, **changes)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "CascadeParams":
        """Apply `fn` to every field (the pytree map of the JAX package)."""
        return CascadeParams(**{f.name: fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)})

    def to(self, device: torch.device | str) -> "CascadeParams":
        return self.map(lambda x: x.to(device))

    @property
    def device(self) -> torch.device:
        return self.wind_speed.device

    @property
    def num_cascades(self) -> int:
        return 1 if self.wind_speed.ndim == 0 else self.wind_speed.shape[0]

    def map_scales(self) -> torch.Tensor:
        """(..., 4) per-cascade (1/Lx, 1/Ly, displacement_scale, normal_scale).

        The material-facing uniform the orchestrator derives per cascade
        (water.gd:102-110); the renderer's `map_scales` argument.
        """
        uv = 1.0 / self.tile_length
        return torch.stack(
            [uv[..., 0], uv[..., 1], self.displacement_scale, self.normal_scale], dim=-1)


def stack_cascades(cascades: Sequence[CascadeParams]) -> CascadeParams:
    """Stack single-cascade params into one with a leading cascade axis."""
    return CascadeParams(**{
        f.name: torch.stack([getattr(c, f.name) for c in cascades])
        for f in dataclasses.fields(CascadeParams)})


# The reference demo scene's 3 cascades (main.tscn:43-83), as plain host dicts.
DEFAULT_SCENE: tuple[dict, ...] = (
    dict(tile_length=(88.0, 88.0), displacement_scale=1.0, normal_scale=1.0,
         wind_speed=10.0, wind_direction=20.0, fetch_length=150.0, swell=0.8,
         spread=0.2, detail=1.0, whitecap=0.5, foam_amount=8.0),
    dict(tile_length=(57.0, 57.0), displacement_scale=0.75, normal_scale=1.0,
         wind_speed=5.0, wind_direction=15.0, fetch_length=150.0, swell=0.8,
         spread=0.4, detail=1.0, whitecap=0.5, foam_amount=0.0),
    dict(tile_length=(16.0, 16.0), displacement_scale=0.0, normal_scale=0.25,
         wind_speed=20.0, wind_direction=20.0, fetch_length=550.0, swell=0.8,
         spread=0.4, detail=1.0, whitecap=0.25, foam_amount=3.0),
)


def default_cascades(seed: int = 1234, godot_seeds: bool = False,
                     device: torch.device | str = "cuda") -> CascadeParams:
    """The reference demo scene's 3 cascades (main.tscn:43-83, DEFAULT_SCENE).

    Spectrum seeds come from a host RNG fixed like the orchestrator's
    (water.gd:68-69) in [-10000, 10000]^2 (water.gd:31); `godot_seeds` draws
    them from the bit-exact pcg32 of Godot's RandomNumberGenerator.
    """
    if godot_seeds:
        from ..utils.godot_rng import GodotRNG
        grng = GodotRNG(seed)
        seeds = [(grng.randi_range(-10000, 10000), grng.randi_range(-10000, 10000))
                 for _ in range(3)]
    else:
        rng = np.random.RandomState(seed)
        seeds = [tuple(int(v) for v in rng.randint(-10000, 10001, 2)) for _ in range(3)]
    return stack_cascades(
        [CascadeParams.create(spectrum_seed=s, device=device, **kw)
         for s, kw in zip(seeds, DEFAULT_SCENE)]
    )


def dual_wind_swell_cascades(seed: int = 77,
                             device: torch.device | str = "cuda") -> CascadeParams:
    """A two-spectrum ocean: local wind sea + long-fetch swell (config 5)."""
    rng = np.random.RandomState(seed)
    seeds = [tuple(int(v) for v in rng.randint(-10000, 10001, 2)) for _ in range(2)]
    wind = CascadeParams.create(
        tile_length=(64.0, 64.0), wind_speed=14.0, wind_direction=25.0,
        fetch_length=80.0, swell=0.2, spread=0.35, detail=1.0,
        whitecap=0.6, foam_amount=6.0, spectrum_seed=seeds[0], device=device)
    swell = CascadeParams.create(
        tile_length=(256.0, 256.0), wind_speed=22.0, wind_direction=-40.0,
        fetch_length=900.0, swell=1.8, spread=0.08, detail=0.6,
        displacement_scale=1.2, whitecap=1.2, foam_amount=1.0,
        spectrum_seed=seeds[1], device=device)
    return stack_cascades([wind, swell])


_MAP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration.

    map_size: FFT/map resolution, a power of two >= 4. It picks the step
      tier (`step_tier`): fused for 16..1024, strip for 2048..8192, staged
      for the rest.
    depth / g: physics constants (wave_generator.gd:5-6).
    map_dtype: "float32" | "bfloat16" | "float16" output maps (fp32 FFT core
      and fp32 foam either way).
    fold_sign: fold the (-1)^(x+y) ifftshift into the staged FFT instead of
      applying it at unpack (same result).
    fused: "auto" runs the fused or strip step where map_size falls in its
      range (the CUDA kernels on a CUDA device, their plain version on the
      CPU); "never" runs the staged modules at every size.
    """
    map_size: int = 1024
    depth: float = 20.0
    g: float = 9.81
    map_dtype: str = "float32"
    fold_sign: bool = True
    fused: str = "auto"

    def __post_init__(self):
        if self.map_size & (self.map_size - 1):
            raise ValueError(f"map_size must be a power of two, got {self.map_size}")
        if self.map_size < 4:
            raise ValueError(f"map_size must be >= 4, got {self.map_size}")
        if self.map_dtype not in _MAP_DTYPES:
            raise ValueError(f"map_dtype must be one of {sorted(_MAP_DTYPES)}, "
                             f"got {self.map_dtype!r}")
        if self.fused not in ("auto", "never"):
            raise ValueError(f"fused must be 'auto' or 'never', got {self.fused!r}")

    def resolved_map_dtype(self) -> torch.dtype:
        return _MAP_DTYPES[self.map_dtype]

    def use_fused_step(self) -> bool:
        """Whether `step` runs the fused kernel pair: 16 <= N <= 1024."""
        return (self.fused != "never"
                and fused_step.MIN_N <= self.map_size <= fused_step.MAX_N)

    def use_strip_step(self) -> bool:
        """Whether `step` runs the strip kernel pair: 1024 < N <= 8192."""
        return (self.fused != "never"
                and strip_step.MIN_N <= self.map_size <= strip_step.MAX_N)

    def step_tier(self) -> str:
        """The path a step takes: "fused", "strip" or "staged"."""
        if self.use_fused_step():
            return "fused"
        return "strip" if self.use_strip_step() else "staged"
