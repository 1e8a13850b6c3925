"""Utilities: CUDA-event timing, the Godot RNG, JAX-package interchange."""
from .convert import params_from_numpy, state_from_numpy, state_to_numpy
from .godot_rng import GodotRNG
from .timing import time_cuda

__all__ = ["params_from_numpy", "state_from_numpy", "state_to_numpy",
           "GodotRNG", "time_cuda"]
