"""Models: cascade parameters and the ocean simulation session."""
from .cascade import (CascadeParams, SimConfig, default_cascades,
                      dual_wind_swell_cascades, stack_cascades)
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
    "CascadeParams", "SimConfig", "default_cascades",
    "dual_wind_swell_cascades", "stack_cascades",
    "Ocean", "OceanMaps", "OceanState", "generate_spectrum", "init_state",
    "multi_step", "refresh_cascades", "simulate", "step", "step_cascade", "step_frames",
]
