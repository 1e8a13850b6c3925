"""Move trees of tensors between the card and host memory.

Counterpart of the JAX package's `utils/hostio.py`, as plain tree moves. A
tree is a dataclass (its init fields), a dict, a list or a tuple, nested;
its tensor leaves move, NumPy arrays become tensors on the way to a device,
and other leaves (numbers, strings, None) pass through. The JAX package
splits complex leaves into fp32 pairs because its TPU backend cannot
transfer complex64; the port's state is fp32 planes, and a complex tensor
moves as it is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.cascade import require_device


def _map_tree(tree, leaf):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return leaf(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tree(getattr(tree, f.name), leaf)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _map_tree(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, leaf) for v in tree)
    return tree


def device_get_tree(tree):
    """The tree with every tensor copied to host memory (CPU tensors that
    share nothing with the originals; NumPy leaves are left as they are)."""
    return _map_tree(tree, lambda x: x.detach().to("cpu", copy=True)
                     if isinstance(x, torch.Tensor) else x)


def device_put_tree(tree, device: torch.device | str = "cuda"):
    """The tree with every tensor and NumPy array copied onto `device`.
    Defaults to the card and raises without one; pass device="cpu" to stay
    on the CPU."""
    device = require_device(device)
    return _map_tree(tree, lambda x: torch.as_tensor(np.array(x) if isinstance(x, np.ndarray)
                                                     else x).to(device, copy=True))
