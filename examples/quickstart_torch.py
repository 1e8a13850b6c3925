"""Quickstart on the PyTorch port: the framework in ~70 lines.

Run from the repo root:  python examples/quickstart_torch.py
(on the CUDA card; add --cpu to run everything on the CPU). The counterpart
of examples/quickstart.py.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from godotoceanwaves_tpu_torch import (
    CascadeParams, Ocean, SimConfig, default_cascades, init_state, step,
)
from godotoceanwaves_tpu_torch.models import FlyCamera, geometry
from godotoceanwaves_tpu_torch.utils import FrameStats, panel

device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"

# --- 1. the five-line version: a session with the reference demo's cascades
ocean = Ocean(map_size=256, updates_per_second=50.0, device=device)
for _ in range(10):
    maps = ocean.update(1 / 60) or ocean.maps
print("displacement planes:", tuple(maps.displacement.shape),   # (C, 3, N, N)
      "normal planes:", tuple(maps.normal.shape))               # (C, 4, N, N)

# --- 2. live parameter editing (the ImGui-panel capability)
ocean.set_cascade(0, wind_speed=18.0, swell=1.2)   # marks cascade 0 dirty
maps = ocean.update(1 / 60) or ocean.maps          # spectrum regenerates here

# --- 3. the functional core (no session object)
config = SimConfig(map_size=128, map_dtype="bfloat16")
params = default_cascades(device=device)
state = init_state(config, params)
state, maps2 = step(config, state, params, 1 / 60)

# --- 4. custom cascades
storm = CascadeParams.create(tile_length=200.0, wind_speed=30.0, fetch_length=900.0,
                             swell=1.5, spectrum_seed=(17, -4), device=device)
solo = storm.map(lambda x: x[None])                # stack of one cascade
sstate = init_state(config, solo)
sstate, storm_maps = step(config, sstate, solo, 1 / 60)
print("storm height rms:", float(storm_maps.displacement[:, 1].float().std()))

# --- 5. shaded render of the DISPLACED clipmap geometry, fly-camera driven
cam = FlyCamera()
cam.move(1.0, forward=-1.0)        # back up 10 m
cam.look(0.0, -20.0)               # tilt down a touch
img = geometry.render_ocean_geometry(
    ocean.maps, ocean.params.map_scales(), "low", width=320, height=180,
    **cam.render_kwargs())
print("rendered (displaced geometry):", tuple(img.shape))

# --- 6. observability
stats = FrameStats()
for _ in range(5):
    stats.tick()
    ocean.update(1 / 60)
print(panel(ocean, stats)[:200], "...")

# --- 7. checkpoint / resume
snapshot = ocean.checkpoint()
ocean2 = Ocean(map_size=256, device=device)
ocean2.restore(snapshot)
print("restored; times:", np.round(ocean2.state.time.cpu().numpy(), 4))
if device == "cuda":
    torch.cuda.synchronize()
