"""Multi-host layout and sharded checkpoints (PyTorch port of
`parallel/multihost.py`).

The axis mapping keeps traffic where it belongs:

  patch — independent ocean patches, no traffic between positions: the axis
      to lay across hosts. `make_multihost_mesh` orders the devices so the
      patch axis strides across processes.
  rows  — the FFT's exchange axis: kept inside one host, on its cards'
      NVLink.

Checkpoints of a sharded state are a directory of one file per mesh
position, each holding only that position's blocks and their global offsets;
a restore reassembles them onto any mesh layout. One process drives the mesh
(see `sharding.py`); the process count comes from `torch.distributed` when
it is initialised.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

from ..models.ocean import OceanMaps, OceanState
from .sharding import _ROW_FIELDS, Mesh, Sharded, build_mesh, cuda_devices, shard_state


def _process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_multihost_mesh(rows: int | None = None, devices=None) -> Mesh:
    """A (patch, rows) mesh whose rows axis never leaves a host.

    `devices` (default: every CUDA device) are grouped by process; each
    rows group is a run of one process's devices, and the patch axis spans
    processes.
    """
    devices = list(devices if devices is not None else cuda_devices())
    n = len(devices)
    procs = max(1, _process_count())
    per_host = n // procs
    if rows is None:
        rows = per_host if per_host > 0 else 1
    if per_host % rows:
        raise ValueError(
            f"rows={rows} must divide the {per_host} devices of one host "
            f"(the FFT exchange must stay inside one host)")
    return build_mesh(devices, rows=rows)


def save_sharded(path, state: Sharded) -> None:
    """Checkpoint a sharded OceanState into the directory `path`.

    Each mesh position writes one file of its own blocks (on the host) and
    their global offsets: `shard_<i>_<j>.pt`. `index.json` names the files.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    files = []
    for i, j, _ in state.mesh.positions():
        block = state.blocks[i][j]
        pl = block.time.shape[0]
        rl = block.foam.shape[-2]
        name = f"shard_{i}_{j}.pt"
        torch.save({"patch_offset": i * pl, "row_offset": j * rl,
                    "fields": {f.name: getattr(block, f.name).detach().cpu()
                               for f in dataclasses.fields(block)}}, path / name)
        files.append(name)
    (path / "index.json").write_text(json.dumps({"files": files}))


def _load_global(path: Path) -> dict[str, torch.Tensor]:
    """Reassemble the global tensors of a checkpoint on the host."""
    shards = [torch.load(path / name, map_location="cpu")
              for name in json.loads((path / "index.json").read_text())["files"]]
    patches = max(s["patch_offset"] + s["fields"]["time"].shape[0] for s in shards)
    out = {}
    for name, x in shards[0]["fields"].items():
        shape = [patches, *x.shape[1:]]
        if name in _ROW_FIELDS:
            shape[-2] = max(s["row_offset"] + s["fields"][name].shape[-2] for s in shards)
        full = torch.empty(shape, dtype=x.dtype)
        for s in shards:
            block = s["fields"][name]
            p0 = s["patch_offset"]
            dst = full[p0:p0 + block.shape[0]]
            if name in _ROW_FIELDS:
                r0 = s["row_offset"]
                dst = dst[..., r0:r0 + block.shape[-2], :]
            dst.copy_(block)
        out[name] = full
    return out


def _global_meta(value: Sharded | OceanState) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Global shape and dtype of each field, read from the blocks' shapes
    (no data is copied)."""
    if not isinstance(value, Sharded):
        return {f.name: (tuple(getattr(value, f.name).shape), getattr(value, f.name).dtype)
                for f in dataclasses.fields(value)}
    blocks = value.blocks
    out = {}
    for f in dataclasses.fields(blocks[0][0]):
        x = getattr(blocks[0][0], f.name)
        shape = [sum(getattr(row[0], f.name).shape[0] for row in blocks), *x.shape[1:]]
        if f.name in _ROW_FIELDS:
            shape[-2] = sum(getattr(b, f.name).shape[-2] for b in blocks[0])
        out[f.name] = (tuple(shape), x.dtype)
    return out


def restore_sharded(path, mesh: Mesh, template: Sharded | OceanState | None = None) -> Sharded:
    """Restore a checkpoint onto `mesh`, whatever layout it was saved from.

    `template`, when given (a state of the same shapes, sharded or global),
    is checked against the checkpoint's global shapes and dtypes.
    """
    tensors = _load_global(Path(path))
    state = OceanState(**tensors)
    if template is not None:
        want = _global_meta(template)
        for name, (shape, dtype) in _global_meta(state).items():
            if (shape, dtype) != want[name]:
                raise ValueError(f"checkpoint {name} is {shape} {dtype}, the template's "
                                 f"{want[name][0]} {want[name][1]}")
    return shard_state(mesh, state)


def gather_maps(maps: Sharded) -> OceanMaps:
    """The global maps on the host, (P, C, {3, 4}, N, N) CPU tensors in
    the maps' dtype (the multi-host analog of `MapStreamer`'s fetch)."""
    return maps.gather("cpu")
