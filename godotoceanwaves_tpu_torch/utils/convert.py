"""Carry parameters and state across from the JAX package as NumPy arrays.

Both packages then compute from identical inputs:

    leaves = {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}
    params = params_from_numpy(leaves, device="cpu")
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..models.cascade import CascadeParams
from ..models.ocean import OceanState


def _tensors(cls, leaves: Mapping[str, np.ndarray], device) -> dict:
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(leaves)
    if missing:
        raise ValueError(f"{cls.__name__} leaves missing: {sorted(missing)}")
    return {name: torch.from_numpy(np.array(leaves[name])).to(device) for name in names}


def params_from_numpy(leaves: Mapping[str, np.ndarray],
                      device: torch.device | str = "cpu") -> CascadeParams:
    """`CascadeParams` from a {field: ndarray} dict (float32 fields, int32 seed)."""
    return CascadeParams(**_tensors(CascadeParams, leaves, device))


def state_from_numpy(leaves: Mapping[str, np.ndarray],
                     device: torch.device | str = "cpu") -> OceanState:
    """`OceanState` from a {field: ndarray} dict (h0, h0nc, omega, foam, time)."""
    return OceanState(**_tensors(OceanState, leaves, device))


def state_to_numpy(state: OceanState) -> dict[str, np.ndarray]:
    """{field: ndarray} of an `OceanState`, copied to the host."""
    return {f.name: getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}
