"""Parallel: device meshes, sharded FFT, multi-patch DP, multi-host layout,
process groups (`multihost.initialize`) and the worker launcher (`launch`)."""
from .sharding import (
    PATCH_AXIS,
    ROWS_AXIS,
    build_mesh,
    ifft2_packed_sharded,
    ifft2_planes_sharded,
    make_multichip_init,
    make_multichip_step,
    multipatch_params,
    render_geometry_sharded,
    shard_state,
)
from .multihost import (
    gather_maps,
    global_devices,
    initialize,
    make_multihost_mesh,
    process_count,
    process_index,
    restore_sharded,
    save_sharded,
    shutdown,
)
from . import launch

__all__ = [
    "PATCH_AXIS", "ROWS_AXIS", "build_mesh", "ifft2_packed_sharded",
    "ifft2_planes_sharded",
    "make_multichip_init", "make_multichip_step", "multipatch_params",
    "render_geometry_sharded", "shard_state",
    "gather_maps", "global_devices", "initialize", "launch", "make_multihost_mesh",
    "process_count", "process_index", "restore_sharded", "save_sharded", "shutdown",
]
