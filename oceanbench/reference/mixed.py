"""The reference of a session whose cascades differ in map size: one `RefOcean` a size group.

`Ocean(map_size=(1024, 256, 64))` groups its cascades by size (the order a
size first appears) and steps each group at its own size, under one session
clock: cascade i starts at 120 + pi i by its index in the whole session,
not in its group. `RefGroup` is `RefOcean` over one group's cascades at the
group's size, with those start times; `RefMixed` holds one a group.

Plain PyTorch and NumPy; imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from .ocean import RefOcean, _f32


def size_groups(sizes) -> list:
    """[(map size, [cascade indices])], a size in the order it first appears."""
    groups: dict = {}
    for i, n in enumerate(sizes):
        groups.setdefault(int(n), []).append(i)
    return list(groups.items())


class RefGroup(RefOcean):
    """`RefOcean` for the cascades `indices` of a session, at `map_size`:
    cascade k of the group starts at 120 + pi indices[k]."""

    def __init__(self, config: dict, specs: list, dt: float, device, map_size: int,
                 indices):
        super().__init__(dict(config, map_size=int(map_size)),
                         [specs[i] for i in indices], dt, device)
        self.indices = tuple(int(i) for i in indices)
        self.t0 = [_f32(_f32(120.0) + _f32(_f32(np.pi) * _f32(i))) for i in self.indices]


class RefMixed:
    """The reference of `Ocean.update` at updates_per_second 0 for the
    cascades `specs` of `config`, cascade i at `config["map_sizes"][i]`:
    `groups`, one `RefGroup` a size group, in the session's group order."""

    def __init__(self, config: dict, specs: list, dt: float, device):
        sizes = config["map_sizes"]
        if len(sizes) != len(specs):
            raise ValueError(f"{len(sizes)} map sizes for {len(specs)} cascades")
        self.groups = [RefGroup(config, specs, dt, device, n, idx)
                       for n, idx in size_groups(sizes)]
