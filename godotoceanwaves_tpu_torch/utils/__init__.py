"""Utilities: CUDA-event timing, the Godot RNG, JAX-package interchange, map streaming."""
from .convert import params_from_numpy, state_from_numpy, state_to_numpy
from .godot_rng import GodotRNG
from .streaming import MapStreamer, preview_maps
from .timing import time_cuda

__all__ = ["params_from_numpy", "state_from_numpy", "state_to_numpy",
           "GodotRNG", "MapStreamer", "preview_maps", "time_cuda"]
