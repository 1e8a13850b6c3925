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

One controller drives the whole mesh, as `jax.shard_map` does: a `Mesh` is
an array of `torch.device`s, a `Sharded` value holds one block per mesh
position on that position's device, and the exchange is a copy between
positions. A device may stand at several positions: on one card,
`build_mesh([cuda:0] * 8, rows=2)` runs all eight positions there and the
exchange is a copy on the card; with one card per position it is a peer copy.
On a CUDA device the row passes are the rows kernel (`ops/rows_fft.py`),
which raises for a row length it does not cover. With rows == 1 a position
holds whole planes and its cascades take the unsharded `step`, so its map
size picks the kernel tier as it does for one patch.

The sharded step marks its stages with `torch.profiler.record_function`
ranges ("sharded/modulate", "sharded/rows_dft", "sharded/exchange",
"sharded/unpack"), so a profiler trace splits the frame's device time by
stage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
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
    """A (patch, rows) array of `torch.device`s; a device may repeat."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: tuple[str, str] = (PATCH_AXIS, ROWS_AXIS)):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or any(len(row) != len(rows[0]) for row in rows) or not rows[0]:
            raise ValueError("a mesh needs a non-empty rectangular array of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, dev in enumerate(row):
                self.devices[i, j] = dev
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self):
        """(patch index, rows index, device) of every position, patch-major."""
        for (i, j), dev in np.ndenumerate(self.devices):
            yield i, j, dev

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def cuda_devices() -> list[torch.device]:
    """Every CUDA device; raises where there is none."""
    require_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def build_mesh(devices: Sequence[torch.device | str] | None = None,
               rows: int | None = None) -> Mesh:
    """A (patch, rows) mesh over the given devices.

    `rows` is the FFT-sharding degree (positions per 2D transform); the rest
    go to patch data-parallelism. Defaults to rows=2 when the device count
    is even, else 1. `devices=None` takes every CUDA device and raises
    without one; the same device may be listed several times.
    """
    devices = list(devices if devices is not None else cuda_devices())
    n = len(devices)
    if rows is None:
        rows = 2 if n % 2 == 0 else 1
    if n % rows:
        raise ValueError(f"{n} devices not divisible by rows={rows}")
    return Mesh([devices[i:i + rows] for i in range(0, n, rows)])


@dataclasses.dataclass
class Sharded:
    """An `OceanState` or `OceanMaps` laid out over a mesh: `blocks[i][j]`
    is the block of mesh position (patch i, rows j), on that position's
    device. Its tensors are (P_l, C, ..., N/D, N): P_l = P / mesh patches
    patches, and texel rows j N/D .. (j + 1) N/D - 1; `time` (P_l, C) is
    the same at every position of a rows group."""
    mesh: Mesh
    blocks: list[list[Any]]

    def gather(self, device: torch.device | str = "cpu"):
        """The global value, its tensors (P, C, ..., N, N) on `device`."""
        first = self.blocks[0][0]
        fields = {}
        for f in dataclasses.fields(first):
            per_patch = []
            for row in self.blocks:
                parts = [getattr(b, f.name).to(device) for b in row]
                per_patch.append(torch.cat(parts, dim=-2) if f.name in _ROW_FIELDS else parts[0])
            fields[f.name] = torch.cat(per_patch, dim=0)
        return type(first)(**fields)


def shard_state(mesh: Mesh, state: OceanState) -> Sharded:
    """Place a global state (h0/h0nc (P, C, 2, N, N), omega/foam (P, C, N, N),
    time (P, C)) onto the mesh."""
    p_dev, r_dev = mesh.devices.shape
    tensors = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    patches = next(iter(tensors.values())).shape[0]
    if patches % p_dev:
        raise ValueError(f"{patches} patches not divisible by the mesh's {p_dev} patch positions")
    pl = patches // p_dev
    blocks = [[None] * r_dev for _ in range(p_dev)]
    for i, j, dev in mesh.positions():
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


def exchange_rows(ys: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The transpose of a rows group: `all_to_all(split_axis=-1,
    concat_axis=-2, tiled=True)` followed by a swap of the last two axes.

    ys[k] is position k's (..., R, N) block of a global (..., N, N) field
    with N = D R. Position j gets the (..., R, N) block of rows j R ..
    (j + 1) R - 1 of the transposed field: column chunk j of every position,
    each chunk transposed into columns k R .. (k + 1) R - 1.
    """
    d = len(ys)
    r, n = ys[0].shape[-2:]
    if r * d != n:
        raise ValueError(f"{d} blocks of {r} rows do not tile a {n}-wide field")
    outs = []
    for j, y_j in enumerate(ys):
        out = torch.empty_like(y_j)
        for k, y_k in enumerate(ys):
            out[..., k * r:(k + 1) * r].copy_(y_k[..., j * r:(j + 1) * r].transpose(-2, -1))
        outs.append(out)
    return outs


def ifft2_planes_sharded(shards: Sequence[torch.Tensor], fold_sign: bool = True
                         ) -> list[torch.Tensor]:
    """The reference chain (rows -> transpose -> rows) on a row-sharded field
    of plane pairs.

    shards[k] is position k's (..., 2, N/D, N) fp32 block of a global
    (..., 2, N, N) field, on its own device. Returns the blocks of
    transpose(N^2 ifft2(x)) (times (-1)^(x+y) with fold_sign), the same
    rows of the output as each input block held.
    """
    with record_function("sharded/rows_dft"):
        ys = [_row_pass(x, fold_sign) for x in shards]
    with record_function("sharded/exchange"):
        swapped = exchange_rows(ys)
    with record_function("sharded/rows_dft"):
        return [_row_pass(y, fold_sign) for y in swapped]


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
        blocks = [[None] * mesh.devices.shape[1] for _ in range(mesh.devices.shape[0])]
        for i, j, dev in mesh.positions():
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
    position copies its patches of it to its device.
    """
    p_dev, r_dev = mesh.devices.shape
    rl = _rows_local(mesh, config)
    map_dtype = config.resolved_map_dtype()

    def step_whole(state: Sharded, params: CascadeParams, dt) -> tuple[Sharded, Sharded]:
        pl = _patches(mesh, params)
        out = [_step_whole(config, state.blocks[i][0], _local_params(params, i, pl, dev), dt)
               for i, _, dev in mesh.positions()]
        return Sharded(mesh, [[s] for s, _ in out]), Sharded(mesh, [[m] for _, m in out])

    def step(state: Sharded, params: CascadeParams, dt) -> tuple[Sharded, Sharded]:
        dt = _f32(dt)
        pl = _patches(mesh, params)
        local = {}
        with record_function("sharded/modulate"):
            for i, j, dev in mesh.positions():
                st = state.blocks[i][j]
                lp = _local_params(params, i, pl, dev)
                t_new = st.time + dt
                layers = modulate_ops.modulate_planes(st.h0, st.h0nc, lp.tile_length,
                                                      config.depth, t_new, config.g,
                                                      omega=st.omega, y_offset=j * rl)
                local[i, j] = (st, lp, t_new, layers)
        fields = {}
        for i in range(p_dev):
            out = ifft2_planes_sharded([local[i, j][3] for j in range(r_dev)], fold_sign=True)
            fields.update({(i, j): f for j, f in enumerate(out)})
        states = [[None] * r_dev for _ in range(p_dev)]
        maps = [[None] * r_dev for _ in range(p_dev)]
        col = lambda x: x[..., None, None]
        with record_function("sharded/unpack"):
            for i, j, _ in mesh.positions():
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
    device.
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
    for i, j, dev in mesh.positions():
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
    first = mesh.devices[0, 0]
    return torch.cat([bands[k].to(first) for k in range(n_dev)], dim=0)
