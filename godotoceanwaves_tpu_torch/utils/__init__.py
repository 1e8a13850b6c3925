"""Utilities: host IO, CUDA-event timing, observability (the program's spans
and counters, `observability.span` / `count` / `tracing`), profiling, the clipmap
mesh, map streaming, the Godot RNG, JAX-package interchange and the ANSI live
viewer. The JAX package's `time_chained` is `time_cuda` here."""
from .hostio import device_get_tree, device_put_tree
from .timing import time_cuda
from .observability import FrameStats, panel
from .clipmap import build_clipmap, build_clipmap_numpy, snap_to_tile
from .convert import (maps_from_numpy, params_from_numpy, sharded_state_from_numpy,
                      spray_state_from_numpy, spray_state_to_numpy, state_from_numpy,
                      state_to_numpy)
from .godot_rng import GodotRNG
from .streaming import MapStreamer, preview_maps
from .profiling import profile_step, trace
from .live import LiveViewer

__all__ = ["device_get_tree", "device_put_tree", "time_cuda", "FrameStats", "panel",
           "build_clipmap", "build_clipmap_numpy", "snap_to_tile", "maps_from_numpy",
           "params_from_numpy", "sharded_state_from_numpy", "spray_state_from_numpy",
           "spray_state_to_numpy", "state_from_numpy", "state_to_numpy", "GodotRNG",
           "MapStreamer", "preview_maps", "profile_step", "trace", "LiveViewer"]
