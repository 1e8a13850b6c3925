"""Utilities: CUDA-event timing, the Godot RNG, JAX-package interchange, map
streaming, the clipmap mesh; `fft_sweep`, run as a module, times the FFT
kernels' launch plans on the card."""
from .clipmap import build_clipmap_numpy, snap_to_tile
from .convert import (maps_from_numpy, params_from_numpy, sharded_state_from_numpy,
                      state_from_numpy, state_to_numpy)
from .godot_rng import GodotRNG
from .streaming import MapStreamer, preview_maps
from .timing import time_cuda

__all__ = ["build_clipmap_numpy", "snap_to_tile", "maps_from_numpy", "params_from_numpy",
           "sharded_state_from_numpy", "state_from_numpy", "state_to_numpy", "GodotRNG",
           "MapStreamer", "preview_maps", "time_cuda"]
