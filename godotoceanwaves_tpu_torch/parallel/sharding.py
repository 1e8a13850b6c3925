"""Multi-device scaling (PyTorch port of `parallel/sharding.py`): patch
data-parallelism and the row-sharded 2D IFFT.

A (patch, rows) mesh of devices:

  axis "patch" — independent ocean patches (and their cascades): no traffic
      between positions.
  axis "rows"  — the FFT row dimension: each position row-transforms its
      N/D rows, the transpose of the reference chain (transpose.glsl) becomes
      an exchange of column chunks inside a rows group (the all-to-all of the
      JAX package), and the row pass runs again. A 2048^2+ map never has to
      sit whole on one device.

Every other stage (spectrum generation, modulation, unpack and foam) is
elementwise in global texel indices, so a position evaluates its own texels
with a `y_offset` and no communication.

One controller may drive the whole mesh, as `jax.shard_map` does: a `Mesh`
is an array of `torch.device`s, a `Sharded` value holds one block per mesh
position on that position's device, and the exchange is a copy between
positions. A device may stand at several positions: on one card,
`build_mesh([cuda:0] * 8, rows=2)` runs all eight positions there and the
exchange is a copy on the card; with one card per position it is a peer copy.
On a CUDA device the row passes are the rows kernel (`ops/rows_fft.py`),
which raises for a row length it does not cover. With rows == 1 a position
holds whole planes and its cascades take the unsharded `step`, so its map
size picks the kernel tier as it does for one patch.

Several processes may drive one mesh, as the JAX package's processes drive
one global mesh: `build_mesh(global_devices())` after
`multihost.initialize()` gives every position its owning process, each
process holds and computes the blocks of its own positions only (`None` at
the others), a rows group that spans processes exchanges its chunks with one
`torch.distributed` `all_to_all_single` over a subgroup of its processes, and
`Sharded.gather` and the banded render all-gather, so every process gets the
global value. A rows group inside one process keeps the copy.

The sharded step marks its stages with `torch.profiler.record_function`
ranges ("sharded/modulate", "sharded/rows_dft", "sharded/exchange",
"sharded/unpack"; "sharded/exchange_collective" for the part of an exchange
that crosses processes), so a profiler trace splits the frame's device time
by stage.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..models.cascade import CascadeParams, SimConfig, require_device
from ..models.ocean import (OceanMaps, OceanState, TIME_OFFSET_BASE, TIME_OFFSET_STEP,
                            _f32, _foam_rates, generate_spectrum_one, step as step_one)
from ..ops import rows_fft, spectra
from ..ops import modulate as modulate_ops, unpack as unpack_ops

ROWS_AXIS = "rows"
PATCH_AXIS = "patch"

# Fields whose second-to-last axis is the texel row axis, split over "rows".
# The rest (time) is replicated over a rows group.
_ROW_FIELDS = frozenset({"h0", "h0nc", "omega", "foam", "displacement", "normal"})


class Mesh:
    """A (patch, rows) array of `torch.device`s; a device may repeat.

    `processes`, when given, is the owning process of each position (an
    array of the same shape): the mesh of a multi-process run, of which each
    process holds its own positions. Without it every position belongs to
    the calling process (one controller), whether or not a process group is
    initialised. Under a process group, a mesh with owners holds positions
    of every process of the group, and every process builds it, in the same
    order as its other meshes: the subgroups of the rows groups that span
    processes are made here, collectively.
    """

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: tuple[str, str] = (PATCH_AXIS, ROWS_AXIS),
                 processes: Sequence[Sequence[int]] | None = None):
        from .multihost import process_index
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or any(len(row) != len(rows[0]) for row in rows) or not rows[0]:
            raise ValueError("a mesh needs a non-empty rectangular array of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.axis_names = tuple(axis_names)
        self.process = process_index()
        self.processes = None
        if processes is not None:
            self.processes = np.asarray(processes, dtype=np.int64)
            if self.processes.shape != self.devices.shape:
                raise ValueError(f"processes {self.processes.shape} do not match the devices "
                                 f"{self.devices.shape}")
        self.collective = self.processes is not None and dist.is_initialized()
        self._groups = self._connect() if self.collective else None

    def _connect(self) -> dict:
        """Check the mesh against the process group; make the subgroup of
        every rows group that spans processes (every process, same order)."""
        world = dist.get_world_size()
        if set(self.processes.flat) != set(range(world)):
            raise ValueError(f"a mesh over processes {sorted(set(self.processes.flat))} must "
                             f"hold positions of every process of the group (0..{world - 1})")
        backend = dist.get_backend()
        for i, j, dev in self.local_positions():
            if backend == "nccl" and dev.type != "cuda":
                raise ValueError(f"position ({i}, {j}) is on {dev}; the nccl backend needs "
                                 "CUDA devices")
        groups = {}
        for row in self.processes:
            ranks = tuple(sorted(set(int(p) for p in row)))
            if len(ranks) > 1 and ranks not in groups:
                groups[ranks] = dist.new_group(list(ranks))
        return groups

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self):
        """(patch index, rows index, device) of every position, patch-major."""
        for (i, j), dev in np.ndenumerate(self.devices):
            yield i, j, dev

    def owner(self, i: int, j: int) -> int:
        """The process that holds position (i, j)."""
        return self.process if self.processes is None else int(self.processes[i, j])

    def local_positions(self):
        """`positions()` of the calling process, patch-major."""
        for i, j, dev in self.positions():
            if self.owner(i, j) == self.process:
                yield i, j, dev

    def rows_group(self, i: int) -> RowsGroup | None:
        """Rows group i (patch position i) when its positions span
        processes; None when one process holds it (the copy exchange)."""
        owners = tuple(self.owner(i, j) for j in range(self.devices.shape[1]))
        if len(set(owners)) == 1:
            return None
        if self._groups is None:
            raise RuntimeError(f"rows group {i} spans processes {sorted(set(owners))}: its "
                               "exchange needs the process group (multihost.initialize) "
                               "initialised before the mesh is built")
        return RowsGroup(owners, self._groups[tuple(sorted(set(owners)))], self.process)

    def __repr__(self) -> str:
        procs = "" if self.processes is None else f", processes={self.processes.tolist()}"
        return (f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})}"
                f"{procs})")


@dataclasses.dataclass(frozen=True)
class RowsGroup:
    """A rows group whose positions span processes: the owning process of
    each of its positions, the `torch.distributed` subgroup of those
    processes, and the calling process."""
    owners: tuple[int, ...]
    group: Any
    process: int


def cuda_devices() -> list[torch.device]:
    """Every CUDA device; raises where there is none."""
    require_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(devices: Sequence[torch.device | str | tuple[int, torch.device]] | None = None,
               rows: int | None = None) -> Mesh:
    """A (patch, rows) mesh over the given devices.

    `rows` is the FFT-sharding degree (positions per 2D transform); the rest
    go to patch data-parallelism. Defaults to rows=2 when the device count
    is even, else 1. `devices=None` takes every CUDA device and raises
    without one; the same device may be listed several times. Entries may
    be (process, device) pairs, such as `multihost.global_devices()` gives:
    the mesh then has owners (a multi-process mesh), and a rows group may
    span processes. Under a process group `devices=None` takes
    `global_devices()`.
    """
    if devices is None:
        from .multihost import global_devices
        devices = global_devices() if dist.is_initialized() else cuda_devices()
    devices = list(devices)
    owned = [isinstance(d, tuple) for d in devices]
    if any(owned) and not all(owned):
        raise ValueError("devices must be all (process, device) pairs or all devices")
    procs = [int(d[0]) for d in devices] if all(owned) and devices else None
    devices = [d[1] for d in devices] if procs is not None else devices
    n = len(devices)
    if rows is None:
        rows = 2 if n % 2 == 0 else 1
    if n % rows:
        raise ValueError(f"{n} devices not divisible by rows={rows}")
    cut = lambda xs: [xs[i:i + rows] for i in range(0, n, rows)]
    return Mesh(cut(devices), processes=None if procs is None else cut(procs))


def _empty(mesh: Mesh) -> list[list[Any]]:
    return [[None] * mesh.devices.shape[1] for _ in range(mesh.devices.shape[0])]


def _byte_view(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


def _all_gather_blocks(mesh: Mesh, blocks: list[list[Any]]) -> list[list[Any]]:
    """Every position's block, on every process: one `all_gather` of each
    process's blocks as bytes (each field at a 16-byte offset), on the
    device of its first position. A move: the blocks arrive bit-equal."""
    local = [(i, j) for i, j, _ in mesh.local_positions()]
    first = blocks[local[0][0]][local[0][1]]
    names = [f.name for f in dataclasses.fields(first)]
    like = [getattr(first, name) for name in names]
    sizes = [t.numel() * t.element_size() for t in like]
    spans = [-(-size // 16) * 16 for size in sizes]
    per = sum(spans)
    owned = [[(i, j) for i, j, _ in mesh.positions() if mesh.owner(i, j) == p]
             for p in range(dist.get_world_size())]
    send = torch.zeros(max(map(len, owned)) * per, dtype=torch.uint8, device=like[0].device)
    for k, (i, j) in enumerate(local):
        at = k * per
        for name, size, span in zip(names, sizes, spans):
            send[at:at + size] = _byte_view(getattr(blocks[i][j], name))
            at += span
    recv = [torch.empty_like(send) for _ in owned]
    dist.all_gather(recv, send)
    out = _empty(mesh)
    for buf, positions in zip(recv, owned):
        for k, (i, j) in enumerate(positions):
            at, fields = k * per, {}
            for name, t, size, span in zip(names, like, sizes, spans):
                fields[name] = buf[at:at + size].view(t.dtype).view(t.shape)
                at += span
            out[i][j] = type(first)(**fields)
    return out


@dataclasses.dataclass
class Sharded:
    """An `OceanState` or `OceanMaps` laid out over a mesh: `blocks[i][j]`
    is the block of mesh position (patch i, rows j), on that position's
    device, or None where another process holds the position. Its tensors
    are (P_l, C, ..., N/D, N): P_l = P / mesh patches patches, and texel
    rows j N/D .. (j + 1) N/D - 1; `time` (P_l, C) is the same at every
    position of a rows group."""
    mesh: Mesh
    blocks: list[list[Any]]

    def gather(self, device: torch.device | str = "cpu"):
        """The global value, its tensors (P, C, ..., N, N) on `device`. On a
        mesh with owners under a process group this is collective: every
        process calls it and gets the global value (the blocks all-gathered,
        bit-equal)."""
        blocks = self.blocks
        if self.mesh.collective:
            blocks = _all_gather_blocks(self.mesh, blocks)
        for i, row in enumerate(blocks):
            for j, block in enumerate(row):
                if block is None:
                    raise RuntimeError(f"position ({i}, {j}) is held by process "
                                       f"{self.mesh.owner(i, j)}: gathering it needs the "
                                       "process group")
        first = blocks[0][0]
        fields = {}
        for f in dataclasses.fields(first):
            per_patch = []
            for row in blocks:
                parts = [getattr(b, f.name).to(device) for b in row]
                per_patch.append(torch.cat(parts, dim=-2) if f.name in _ROW_FIELDS else parts[0])
            fields[f.name] = torch.cat(per_patch, dim=0)
        return type(first)(**fields)


def shard_state(mesh: Mesh, state: OceanState) -> Sharded:
    """Place a global state (h0/h0nc (P, C, 2, N, N), omega/foam (P, C, N, N),
    time (P, C)) onto the mesh: the calling process's positions."""
    p_dev, r_dev = mesh.devices.shape
    tensors = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    patches = next(iter(tensors.values())).shape[0]
    if patches % p_dev:
        raise ValueError(f"{patches} patches not divisible by the mesh's {p_dev} patch positions")
    pl = patches // p_dev
    blocks = _empty(mesh)
    for i, j, dev in mesh.local_positions():
        block = {}
        for name, x in tensors.items():
            x = x[i * pl:(i + 1) * pl]
            if name in _ROW_FIELDS:
                n = x.shape[-2]
                if n % r_dev:
                    raise ValueError(f"{n} rows not divisible by the mesh's {r_dev} row positions")
                rl = n // r_dev
                x = x[..., j * rl:(j + 1) * rl, :]
            block[name] = x.to(dev).contiguous()
        blocks[i][j] = OceanState(**block)
    return Sharded(mesh, blocks)


def _row_pass(planes: torch.Tensor, fold_sign: bool) -> torch.Tensor:
    """The shard-local row DFT of (..., 2, R, N) planes (`ops/rows_fft.py`)."""
    flat = planes.contiguous().reshape((-1,) + planes.shape[-3:])
    return rows_fft.idft_rows_planes(flat, fold_sign=fold_sign).reshape(planes.shape)


def exchange_rows(ys: Sequence[torch.Tensor | None], group: RowsGroup | None = None
                  ) -> list[torch.Tensor | None]:
    """The transpose of a rows group: `all_to_all(split_axis=-1,
    concat_axis=-2, tiled=True)` followed by a swap of the last two axes.

    ys[k] is position k's (..., R, N) block of a global (..., N, N) field
    with N = D R. Position j gets the (..., R, N) block of rows j R ..
    (j + 1) R - 1 of the transposed field: column chunk j of every position,
    each chunk transposed into columns k R .. (k + 1) R - 1.

    With `group` (a rows group spanning processes, `Mesh.rows_group`), ys
    holds the calling process's blocks and None at the others' positions,
    and so does the result; the chunks cross processes in one
    `all_to_all_single`. Either way the exchange only moves bytes.
    """
    d = len(ys)
    r, n = next(y for y in ys if y is not None).shape[-2:]
    if r * d != n:
        raise ValueError(f"{d} blocks of {r} rows do not tile a {n}-wide field")
    if group is not None:
        with record_function("sharded/exchange_collective"):
            return _exchange_across(ys, group, r)
    outs = []
    for j, y_j in enumerate(ys):
        out = torch.empty_like(y_j)
        for k, y_k in enumerate(ys):
            out[..., k * r:(k + 1) * r].copy_(y_k[..., j * r:(j + 1) * r].transpose(-2, -1))
        outs.append(out)
    return outs


def _exchange_across(ys: Sequence[torch.Tensor | None], group: RowsGroup, r: int
                     ) -> list[torch.Tensor | None]:
    """`exchange_rows` over processes. Process q's part of the one buffer
    sent to process p holds, for each of p's positions j and each of q's
    positions k (both ascending), column chunk j of block k; the receiver
    transposes chunk (j, k) into columns k R .. (k + 1) R - 1 of its block j.
    Every process of the subgroup sends and receives the same count."""
    ranks = sorted(set(group.owners))
    held = {p: [k for k, o in enumerate(group.owners) if o == p] for p in ranks}
    mine = held[group.process]
    lead = ys[mine[0]].shape[:-1]
    chunk = math.prod(lead) * r
    splits = [len(held[p]) * len(mine) * chunk for p in ranks]
    send = torch.empty(sum(splits), dtype=ys[mine[0]].dtype, device=ys[mine[0]].device)
    at = 0
    for p in ranks:
        for j in held[p]:
            for k in mine:
                send[at:at + chunk].view(lead + (r,)).copy_(ys[k][..., j * r:(j + 1) * r])
                at += chunk
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, splits, splits, group=group.group)
    outs = [None if y is None else torch.empty_like(y) for y in ys]
    at = 0
    for p in ranks:
        for j in mine:
            for k in held[p]:
                outs[j][..., k * r:(k + 1) * r].copy_(
                    recv[at:at + chunk].view(lead + (r,)).transpose(-2, -1))
                at += chunk
    return outs


def ifft2_planes_sharded(shards: Sequence[torch.Tensor | None], fold_sign: bool = True,
                         group: RowsGroup | None = None) -> list[torch.Tensor | None]:
    """The reference chain (rows -> transpose -> rows) on a row-sharded field
    of plane pairs.

    shards[k] is position k's (..., 2, N/D, N) fp32 block of a global
    (..., 2, N, N) field, on its own device. Returns the blocks of
    transpose(N^2 ifft2(x)) (times (-1)^(x+y) with fold_sign), the same
    rows of the output as each input block held. With `group`, the
    positions of other processes are None, in and out (`exchange_rows`).
    """
    with record_function("sharded/rows_dft"):
        ys = [None if x is None else _row_pass(x, fold_sign) for x in shards]
    with record_function("sharded/exchange"):
        swapped = exchange_rows(ys, group)
    with record_function("sharded/rows_dft"):
        return [None if y is None else _row_pass(y, fold_sign) for y in swapped]


def ifft2_packed_sharded(shards: Sequence[torch.Tensor], fold_sign: bool = True
                         ) -> list[torch.Tensor]:
    """`ifft2_planes_sharded` on complex blocks (..., N/D, N), through the
    plane pairs, so a CUDA device runs the rows kernel here too."""
    planes = [torch.stack([x.real, x.imag], dim=-3).contiguous() for x in shards]
    return [torch.complex(y[..., 0, :, :], y[..., 1, :, :])
            for y in ifft2_planes_sharded(planes, fold_sign)]


def multipatch_params(base: CascadeParams, num_patches: int, seed: int = 0) -> CascadeParams:
    """Broadcast (C,)-stacked params to (P, C) with independent per-patch seeds.

    Identical seeds would make every patch the same ocean; seeds are the only
    field that varies across patches by default. The seeds are those of the
    JAX package's `multipatch_params` for the same `seed`.
    """
    rng = np.random.RandomState(seed)
    tiled = base.map(lambda x: x[None].expand((num_patches,) + tuple(x.shape)).clone())
    seeds = rng.randint(-10000, 10001, size=(num_patches,) + tuple(base.spectrum_seed.shape))
    return tiled.replace(spectrum_seed=torch.from_numpy(seeds.astype(np.int32)).to(base.device))


def _patches(mesh: Mesh, params: CascadeParams) -> int:
    """Patches per patch position."""
    patches = params.wind_speed.shape[0]
    p_dev = mesh.devices.shape[0]
    if params.wind_speed.ndim != 2 or patches % p_dev:
        raise ValueError(f"params must be (P, C) with P divisible by {p_dev}, got "
                         f"{tuple(params.wind_speed.shape)}")
    return patches // p_dev


def _local_params(params: CascadeParams, i: int, pl: int, dev) -> CascadeParams:
    return params.map(lambda x: x[i * pl:(i + 1) * pl].to(dev))


def _rows_local(mesh: Mesh, config: SimConfig) -> int:
    r_dev = mesh.devices.shape[1]
    if config.map_size % r_dev:
        raise ValueError(f"map_size {config.map_size} not divisible by rows={r_dev}")
    return config.map_size // r_dev


def make_multichip_init(mesh: Mesh, config: SimConfig):
    """Sharded state initializer: params (P, C) -> a `Sharded` OceanState.

    Each position generates its own rows of h0/h0nc; the dispersion plane
    omega is computed on the host in NumPy (spectra.dispersion_grid_host),
    as the unsharded `init_state` does.
    """
    n = config.map_size
    rl = _rows_local(mesh, config)

    def init(params: CascadeParams) -> Sharded:
        pl = _patches(mesh, params)
        c = params.wind_speed.shape[1]
        tiles = params.tile_length.detach().cpu().numpy().astype(np.float32)   # (P, C, 2)
        blocks = _empty(mesh)
        for i, j, dev in mesh.local_positions():
            lp = _local_params(params, i, pl, dev)
            y0 = j * rl
            pairs = [[generate_spectrum_one(config, lp.map(lambda x: x[a, b]), y0, rl)
                      for b in range(c)] for a in range(pl)]
            omega = np.stack([np.stack([
                spectra.dispersion_grid_host(n, tiles[i * pl + a, b], config.depth, config.g,
                                             rows=rl, y_offset=y0)
                for b in range(c)]) for a in range(pl)])
            time = TIME_OFFSET_BASE + TIME_OFFSET_STEP * torch.arange(
                c, dtype=torch.float32, device=dev)
            blocks[i][j] = OceanState(
                h0=torch.stack([torch.stack([h for h, _ in row]) for row in pairs]),
                h0nc=torch.stack([torch.stack([h for _, h in row]) for row in pairs]),
                omega=torch.from_numpy(omega).to(dev),
                foam=torch.zeros((pl, c, rl, n), dtype=torch.float32, device=dev),
                time=time.expand(pl, c).contiguous())
        return Sharded(mesh, blocks)

    return init


def _step_whole(config: SimConfig, st: OceanState, lp: CascadeParams, dt
                ) -> tuple[OceanState, OceanMaps]:
    """A rows == 1 position: its (P_l, C) cascades go through the unsharded
    `step` as one batch of P_l C cascades, on the kernel tier of the map
    size."""
    pl, c = st.time.shape
    flat = lambda x: x.reshape((pl * c,) + tuple(x.shape[2:]))
    unflat = lambda x: x.reshape((pl, c) + tuple(x.shape[1:]))
    fields = lambda v, fn: {f.name: fn(getattr(v, f.name)) for f in dataclasses.fields(v)}
    new, maps = step_one(config, OceanState(**fields(st, flat)), lp.map(flat), dt)
    return OceanState(**fields(new, unflat)), OceanMaps(**fields(maps, unflat))


def make_multichip_step(mesh: Mesh, config: SimConfig):
    """Sharded step: (state, params, dt) -> (state, maps), both `Sharded`.

    State and maps carry a leading patch axis: h0/h0nc (P, C, 2, N, N), foam
    (P, C, N, N), maps (P, C, {3, 4}, N, N), cut over the mesh. With
    rows > 1, per position: modulate its rows; then the row-sharded 2D IFFT
    over each rows group, the ifftshift sign folded in; then unpack and foam
    on its rows. With rows == 1 each position runs the unsharded `step` on
    its patches. `params` (P, C) should sit on the mesh's device(s): a
    position copies its patches of it to its device. A process computes its
    own positions (every process holds the whole params, as JAX replicates
    them); a rows group spanning processes exchanges collectively, so every
    process of a multi-process mesh steps together.
    """
    r_dev = mesh.devices.shape[1]
    rl = _rows_local(mesh, config)
    map_dtype = config.resolved_map_dtype()

    def step_whole(state: Sharded, params: CascadeParams, dt) -> tuple[Sharded, Sharded]:
        pl = _patches(mesh, params)
        states, maps = _empty(mesh), _empty(mesh)
        for i, j, dev in mesh.local_positions():
            states[i][j], maps[i][j] = _step_whole(config, state.blocks[i][j],
                                                   _local_params(params, i, pl, dev), dt)
        return Sharded(mesh, states), Sharded(mesh, maps)

    def step(state: Sharded, params: CascadeParams, dt) -> tuple[Sharded, Sharded]:
        dt = _f32(dt)
        pl = _patches(mesh, params)
        local = {}
        with record_function("sharded/modulate"):
            for i, j, dev in mesh.local_positions():
                st = state.blocks[i][j]
                lp = _local_params(params, i, pl, dev)
                t_new = st.time + dt
                layers = modulate_ops.modulate_planes(st.h0, st.h0nc, lp.tile_length,
                                                      config.depth, t_new, config.g,
                                                      omega=st.omega, y_offset=j * rl)
                local[i, j] = (st, lp, t_new, layers)
        fields = {}
        for i in sorted({i for i, _ in local}):
            out = ifft2_planes_sharded([local[i, j][3] if (i, j) in local else None
                                        for j in range(r_dev)],
                                       fold_sign=True, group=mesh.rows_group(i))
            fields.update({(i, j): f for j, f in enumerate(out) if f is not None})
        states, maps = _empty(mesh), _empty(mesh)
        col = lambda x: x[..., None, None]
        with record_function("sharded/unpack"):
            for i, j, _ in mesh.local_positions():
                st, lp, t_new, _ = local[i, j]
                grow, decay = _foam_rates(lp, dt)
                disp, normal, foam = unpack_ops.unpack_planes(
                    fields[i, j], st.foam, col(lp.whitecap), col(grow), col(decay),
                    pre_shifted=True, map_dtype=map_dtype)
                states[i][j] = st.replace(foam=foam, time=t_new)
                maps[i][j] = OceanMaps(displacement=disp, normal=normal)
        return Sharded(mesh, states), Sharded(mesh, maps)

    return step_whole if r_dev == 1 else step


def render_geometry_sharded(mesh: Mesh, maps: OceanMaps, map_scales: torch.Tensor,
                            axes: str | Sequence[str] | None = None, *,
                            width: int = 960, height: int = 540,
                            camera_pos=(0.0, 12.0, 0.0), pitch_deg=-12.0,
                            yaw_deg=0.0, **kw) -> torch.Tensor:
    """Multi-device displaced-geometry render: bands of pixel rows over the mesh.

    The renderer (`models/geometry.render_ocean_geometry`) is per-pixel
    independent given the displaced grid, and the maps are small, so each
    position renders one horizontal band of the frame through the
    renderer's `rows` window on its device and the bands are concatenated.

    `axes` picks the mesh axes to spread rows over (default: all of them,
    major-to-minor); positions along the other axes would render the same
    band, so the first of them does. `height` must be divisible by the
    product of their sizes. Per-band choices then follow the band: the
    gradient LOD, the decimated taps of `shade_res`, and the fan march's
    row groups (the largest divisor of the band height up to its target), so
    such frames may differ from the dense one at a few pixels; with those
    off (a per-pixel march, no LOD, shade_res=1) the bands equal the dense
    rows. Returns the assembled (H, W, 3) image on the first position's
    device. On a multi-process mesh each process renders the bands of its
    own positions and the bands are all-gathered (collective): every process
    returns the whole image, on the device of its first position. `maps`
    is the same in every process.
    """
    from ..models import geometry

    if axes is None:
        names = tuple(mesh.axis_names)
    elif isinstance(axes, str):
        names = (axes,)
    else:
        names = tuple(axes)
    shape = mesh.shape
    n_dev = int(np.prod([shape[a] for a in names]))
    if height % n_dev:
        raise ValueError(f"height {height} not divisible by {n_dev} devices")
    local_h = height // n_dev
    bands = {}
    for i, j, dev in mesh.local_positions():
        index = dict(zip(mesh.axis_names, (i, j)))
        if any(index[a] for a in mesh.axis_names if a not in names):
            continue
        idx = 0
        for a in names:
            idx = idx * shape[a] + index[a]
        local_maps = OceanMaps(displacement=maps.displacement.to(dev),
                               normal=maps.normal.to(dev))
        bands[idx] = geometry.render_ocean_geometry(
            local_maps, map_scales.to(dev), width=width, height=height, camera_pos=camera_pos,
            pitch_deg=pitch_deg, yaw_deg=yaw_deg, rows=(idx * local_h, local_h), **kw)
    first = next(mesh.local_positions())[2]
    if mesh.collective:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, {k: band.cpu() for k, band in bands.items()})
        bands = {k: band for part in every for k, band in part.items()}
    return torch.cat([bands[k].to(first) for k in range(n_dev)], dim=0)
