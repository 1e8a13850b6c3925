"""Carry parameters, state and maps across from the JAX package as NumPy arrays.

Both packages then compute from identical inputs:

    leaves = {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}
    params = params_from_numpy(leaves, device="cpu")

A JAX `SprayState` crosses with `spray_state_from_numpy`, so both packages
advance the same particles.

`params_from_numpy`, `state_from_numpy`, `maps_from_numpy` and
`spray_state_from_numpy` default to the card, like the port's other entry
points, and raise when none is present: pass `device="cpu"` to stay on the
CPU. A multipatch `CascadeParams` (P, C) crosses the same way; a sharded JAX
state crosses gathered to global NumPy arrays and is cut again over the
port's mesh (`sharded_state_from_numpy`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..models.cascade import CascadeParams, require_device
from ..models.ocean import OceanMaps, OceanState
from ..models.spray import SprayState
from ..parallel.sharding import Mesh, Sharded, shard_state

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _tensors(cls, leaves: Mapping[str, np.ndarray], device) -> dict:
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(leaves)
    if missing:
        raise ValueError(f"{cls.__name__} leaves missing: {sorted(missing)}")
    device = require_device(device)
    return {name: torch.from_numpy(np.array(leaves[name])).to(device) for name in names}


def params_from_numpy(leaves: Mapping[str, np.ndarray],
                      device: torch.device | str = "cuda") -> CascadeParams:
    """`CascadeParams` from a {field: ndarray} dict (float32 fields, int32 seed)."""
    return CascadeParams(**_tensors(CascadeParams, leaves, device))


def state_from_numpy(leaves: Mapping[str, np.ndarray],
                     device: torch.device | str = "cuda") -> OceanState:
    """`OceanState` from a {field: ndarray} dict (h0, h0nc, omega, foam, time)."""
    return OceanState(**_tensors(OceanState, leaves, device))


def sharded_state_from_numpy(leaves: Mapping[str, np.ndarray], mesh: Mesh) -> Sharded:
    """A `Sharded` OceanState on `mesh` from the global {field: ndarray} of a
    multipatch state (h0/h0nc (P, C, 2, N, N), omega/foam (P, C, N, N),
    time (P, C)). The global state is staged on the CPU and cut from there
    onto the mesh's devices."""
    return shard_state(mesh, state_from_numpy(leaves, device="cpu"))


def state_to_numpy(state: OceanState) -> dict[str, np.ndarray]:
    """{field: ndarray} of an `OceanState`, copied to the host."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}


def spray_state_from_numpy(leaves: Mapping[str, np.ndarray],
                           device: torch.device | str = "cuda") -> SprayState:
    """`SprayState` from a {field: ndarray} dict (float32 fields, bool
    active / has_started, int32 cycle; dtypes kept)."""
    return SprayState(**_tensors(SprayState, leaves, device))


def spray_state_to_numpy(state: SprayState) -> dict[str, np.ndarray]:
    """{field: ndarray} of a `SprayState`, copied to the host."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}


def maps_from_numpy(displacement: np.ndarray, normal: np.ndarray,
                    dtype: str | torch.dtype | None = None,
                    device: torch.device | str = "cuda") -> OceanMaps:
    """`OceanMaps` from the JAX package's maps as NumPy arrays.

    displacement (C, 3, N, N) and normal (C, 4, N, N), channel-first. Arrays
    of a dtype NumPy lacks (JAX's bfloat16) should arrive as float32: the
    widening is exact, and `dtype` ("bfloat16", "float16", "float32" or a
    torch dtype; None keeps the arrays' own) rounds them back here, which
    restores the original values exactly.
    """
    device = require_device(device)
    if isinstance(dtype, str):
        dtype = _TORCH_DTYPES[dtype]

    def conv(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32 if dtype is not None else None))
        return (t if dtype is None else t.to(dtype)).to(device)
    return OceanMaps(displacement=conv(displacement), normal=conv(normal))
