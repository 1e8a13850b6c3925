"""Multi-host layout, process start and sharded checkpoints (PyTorch port of
`parallel/multihost.py`).

The axis mapping keeps traffic where it belongs:

  patch — independent ocean patches, no traffic between positions: the axis
      to lay across hosts. `make_multihost_mesh` orders the devices so the
      patch axis strides across processes.
  rows  — the FFT's exchange axis: kept inside one host, on its cards'
      NVLink.

One process may drive the whole mesh (see `sharding.py`), or several may
drive one mesh, each holding the positions of its own devices, as the JAX
package's processes do after `jax.distributed.initialize()`:

  initialize()                        # every process: torch.distributed
  mesh = make_multihost_mesh(rows=4)  # the global devices, by process
  step = make_multichip_step(mesh, config)   # from .sharding

`initialize` reads `torchrun`'s variables (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, LOCAL_RANK) when given no arguments; `launch.run` starts
workers on one machine. NCCL serves CUDA positions, gloo CPU positions (or
CUDA tensors where a test asks for it); nothing falls back to another
backend or device.

Checkpoints of a sharded state are a directory of one file per mesh
position, each holding only that position's blocks, and one index per
writing process naming its files and their global offsets: each process
writes only its own positions and reads only the files that overlap its
positions, and a restore reassembles them onto any mesh layout and any
process count.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
from pathlib import Path

import torch
import torch.distributed as dist

from ..models.cascade import require_device
from ..models.ocean import OceanMaps, OceanState
from .sharding import _ROW_FIELDS, Mesh, Sharded, _empty, build_mesh, cuda_devices

_local_device: torch.device | None = None   # set by `initialize`, cleared by `shutdown`


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               local_device: torch.device | str | None = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group (the counterpart of `jax.distributed.initialize`).

    `coordinator_address` is "host:port" (a TCP store that process 0
    serves) or an init URL such as "file:///tmp/store"; with none, the
    `torchrun` variables are read (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE). `local_device` is this process's device, by default
    cuda:LOCAL_RANK, which raises without a card. `backend` defaults to
    "nccl" for a CUDA device and "gloo" for the CPU; "nccl" on a CPU device
    or where NCCL is missing raises. On CUDA the device becomes the current
    one.
    """
    global _local_device
    env = os.environ
    needed = ([] if coordinator_address else ["MASTER_ADDR", "MASTER_PORT"]) + \
        ([] if num_processes is not None else ["WORLD_SIZE"]) + \
        ([] if process_id is not None else ["RANK"])
    missing = [k for k in needed if k not in env]
    if missing:
        raise RuntimeError(f"initialize() needs torchrun's {', '.join(missing)}, or "
                           "coordinator_address, num_processes and process_id")
    if coordinator_address is None:
        init_method = "env://"      # torchrun's store, read from MASTER_ADDR / MASTER_PORT
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else env["RANK"])
    device = require_device(local_device if local_device is not None
                            else torch.device("cuda", int(env.get("LOCAL_RANK", 0))))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
        if not dist.is_nccl_available():
            raise RuntimeError("the nccl backend is not available in this torch build")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **extra)
    _local_device = device


def shutdown() -> None:
    """Leave the process group, if any."""
    global _local_device
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _local_device = None


def process_index() -> int:
    """This process's rank in the group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device() -> torch.device:
    """The device `initialize` was given; raises without a process group."""
    if _local_device is None:
        raise RuntimeError("no process group: call multihost.initialize() first")
    return _local_device


def global_devices(local=None) -> list[tuple[int, torch.device]]:
    """(process, device) of every device of every process, by process: the
    global device list a mesh with owners is built from (`build_mesh`), as
    `jax.devices()` is. `local` lists this process's devices, one per mesh
    position it holds (a device may repeat); by default the device of
    `initialize`. Collective under a process group (an all_gather of the
    lists); without one, `local` or every CUDA device, all of process 0.
    """
    if not (dist.is_available() and dist.is_initialized()):
        return [(0, torch.device(d)) for d in (local if local is not None else cuda_devices())]
    mine = [str(torch.device(d)) for d in (local if local is not None else [local_device()])]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [(p, torch.device(d)) for p, devices in enumerate(every) for d in devices]


def make_multihost_mesh(rows: int | None = None, devices=None) -> Mesh:
    """A (patch, rows) mesh whose rows axis never leaves a host.

    `devices` (default: `global_devices()` under a process group, else
    every CUDA device) are grouped by process; each rows group is a run of
    one process's devices, and the patch axis spans processes. Bare devices
    belong to the calling process.
    """
    if devices is None:
        devices = global_devices() if dist.is_initialized() else cuda_devices()
    devices = list(devices)
    owned = bool(devices) and all(isinstance(d, tuple) for d in devices)
    if owned:
        devices = sorted(devices, key=lambda pd: pd[0])   # stable: each process's order kept
    n = len(devices)
    counts = [sum(1 for p, _ in devices if p == q) for q in sorted({p for p, _ in devices})] \
        if owned else [n]
    if len(set(counts)) > 1:
        raise ValueError(f"every process must hold as many devices as the others: {counts}")
    per_host = counts[0] if counts else 0
    if rows is None:
        rows = per_host if per_host > 0 else 1
    if per_host % rows:
        raise ValueError(
            f"rows={rows} must divide the {per_host} devices of one host "
            f"(the FFT exchange must stay inside one host)")
    return build_mesh(devices, rows=rows)


def _index_name(writer: int) -> str:
    return f"index_{writer}.json"


def save_sharded(path, state: Sharded) -> None:
    """Checkpoint a sharded OceanState into the directory `path`.

    Each process writes one file per position it holds, of that position's
    blocks on the host (`shard_<i>_<j>.pt`, tensors only), and an index of
    its own (`index_<process>.json`: the files, their global offsets, the
    fields' block shapes and dtypes, and the number of writers). On a mesh
    with owners under a process group it is collective: it returns once
    every process has written.
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    mesh = state.mesh
    writer, writers = (mesh.process, process_count()) if mesh.collective else (0, 1)
    files, fields = [], None
    for i, j, _ in mesh.local_positions():
        block = state.blocks[i][j]
        pl, rl = block.time.shape[0], block.foam.shape[-2]
        name = f"shard_{i}_{j}.pt"
        tensors = {f.name: getattr(block, f.name).detach().cpu()
                   for f in dataclasses.fields(block)}
        torch.save({"patch_offset": i * pl, "row_offset": j * rl, "fields": tensors},
                   path / name)
        files.append({"file": name, "patch_offset": i * pl, "patches": pl,
                      "row_offset": j * rl, "rows": rl})
        fields = {k: [list(t.shape), str(t.dtype).removeprefix("torch.")]
                  for k, t in tensors.items()}
    (path / _index_name(writer)).write_text(json.dumps(
        {"writers": writers, "files": files, "fields": fields}))
    if mesh.collective:
        dist.barrier()


def _read_indexes(path: Path) -> tuple[list[dict], dict]:
    """(every file's entry, the fields' block shapes and dtypes) of a
    checkpoint, from the indexes of all its writers."""
    first = json.loads((path / _index_name(0)).read_text())
    entries = []
    for writer in range(first["writers"]):
        entries += json.loads((path / _index_name(writer)).read_text())["files"]
    return entries, first["fields"]


def _checkpoint_meta(entries: list[dict], fields: dict) -> dict:
    """Global shape and dtype of each field of a checkpoint."""
    patches = max(e["patch_offset"] + e["patches"] for e in entries)
    rows = max(e["row_offset"] + e["rows"] for e in entries)
    out = {}
    for name, (shape, dtype) in fields.items():
        shape = [patches, *shape[1:]]
        if name in _ROW_FIELDS:
            shape[-2] = rows
        out[name] = (tuple(shape), getattr(torch, dtype))
    return out


def _global_meta(value: Sharded | OceanState) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Global shape and dtype of each field, read from the blocks' shapes
    (no data is copied)."""
    if not isinstance(value, Sharded):
        return {f.name: (tuple(getattr(value, f.name).shape), getattr(value, f.name).dtype)
                for f in dataclasses.fields(value)}
    p_dev, r_dev = value.mesh.devices.shape
    i, j, _ = next(value.mesh.local_positions())
    block = value.blocks[i][j]
    out = {}
    for f in dataclasses.fields(block):
        x = getattr(block, f.name)
        shape = [x.shape[0] * p_dev, *x.shape[1:]]
        if f.name in _ROW_FIELDS:
            shape[-2] = x.shape[-2] * r_dev
        out[f.name] = (tuple(shape), x.dtype)
    return out


def restore_sharded(path, mesh: Mesh, template: Sharded | OceanState | None = None) -> Sharded:
    """Restore a checkpoint onto `mesh`, whatever layout and process count
    it was saved from.

    Each process loads only the files that overlap its own positions.
    `template`, when given (a state of the same shapes, sharded or global),
    is checked against the checkpoint's global shapes and dtypes first.
    """
    path = Path(path)
    entries, fields = _read_indexes(path)
    meta = _checkpoint_meta(entries, fields)
    if template is not None:
        want = _global_meta(template)
        for name, (shape, dtype) in meta.items():
            if (shape, dtype) != want[name]:
                raise ValueError(f"checkpoint {name} is {shape} {dtype}, the template's "
                                 f"{want[name][0]} {want[name][1]}")
    p_dev, r_dev = mesh.devices.shape
    patches, n = meta["foam"][0][0], meta["foam"][0][-2]
    if patches % p_dev or n % r_dev:
        raise ValueError(f"a ({patches} patches, {n} rows) checkpoint is not divisible over "
                         f"the mesh's {mesh.shape}")
    pl, rl = patches // p_dev, n // r_dev
    loaded = {}
    blocks = _empty(mesh)
    for i, j, dev in mesh.local_positions():
        p0, r0 = i * pl, j * rl
        block = {}
        for name, (shape, dtype) in meta.items():
            shape = [pl, *shape[1:]]
            if name in _ROW_FIELDS:
                shape[-2] = rl
            block[name] = torch.empty(shape, dtype=dtype)
        for e in entries:
            lo_p, hi_p = max(p0, e["patch_offset"]), min(p0 + pl, e["patch_offset"] + e["patches"])
            lo_r, hi_r = max(r0, e["row_offset"]), min(r0 + rl, e["row_offset"] + e["rows"])
            if lo_p >= hi_p or lo_r >= hi_r:
                continue
            if e["file"] not in loaded:
                loaded[e["file"]] = torch.load(path / e["file"], map_location="cpu",
                                               weights_only=True)["fields"]
            for name, x in loaded[e["file"]].items():
                src = x[lo_p - e["patch_offset"]:hi_p - e["patch_offset"]]
                dst = block[name][lo_p - p0:hi_p - p0]
                if name in _ROW_FIELDS:
                    src = src[..., lo_r - e["row_offset"]:hi_r - e["row_offset"], :]
                    dst = dst[..., lo_r - r0:hi_r - r0, :]
                dst.copy_(src)
        blocks[i][j] = OceanState(**{k: v.to(dev) for k, v in block.items()})
    return Sharded(mesh, blocks)


def gather_maps(maps: Sharded) -> OceanMaps:
    """The global maps on the host, (P, C, {3, 4}, N, N) CPU tensors in
    the maps' dtype (the multi-host analog of `MapStreamer`'s fetch).
    Collective on a multi-process mesh: every process gets them."""
    return maps.gather("cpu")
