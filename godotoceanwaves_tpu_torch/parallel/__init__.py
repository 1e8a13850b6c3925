"""Parallel: device meshes, sharded FFT, multi-patch DP, multi-host layout."""
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
    make_multihost_mesh,
    restore_sharded,
    save_sharded,
)

__all__ = [
    "PATCH_AXIS", "ROWS_AXIS", "build_mesh", "ifft2_packed_sharded",
    "ifft2_planes_sharded",
    "make_multichip_init", "make_multichip_step", "multipatch_params",
    "render_geometry_sharded", "shard_state",
    "gather_maps", "make_multihost_mesh", "restore_sharded", "save_sharded",
]
