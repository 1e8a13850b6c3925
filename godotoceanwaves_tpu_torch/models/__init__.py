"""Models: cascade parameters, the ocean simulation session, the fly camera,
spray, shading, the displaced-geometry renderer and the scene renderer."""
from .camera import FlyCamera
from .cascade import (CascadeParams, SimConfig, default_cascades,
                      dual_wind_swell_cascades, stack_cascades)
from .geometry import (CLIPMAP_PRESETS, clipmap_axis_coords, displaced_grid,
                       render_ocean_geometry, surface_height)
from .viewport import SceneRenderer, SpraySession
from .ocean import (
    Ocean,
    OceanMaps,
    OceanState,
    generate_spectrum,
    init_state,
    multi_step,
    refresh_cascades,
    simulate,
    step,
    step_cascade,
    step_frames,
)

__all__ = [
    "FlyCamera", "CLIPMAP_PRESETS", "clipmap_axis_coords", "displaced_grid",
    "render_ocean_geometry", "surface_height", "CascadeParams", "SimConfig", "default_cascades",
    "dual_wind_swell_cascades", "stack_cascades", "SceneRenderer", "SpraySession",
    "Ocean", "OceanMaps", "OceanState", "generate_spectrum", "init_state",
    "multi_step", "refresh_cascades", "simulate", "step", "step_cascade", "step_frames",
]
