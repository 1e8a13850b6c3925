"""The spray composite as one chain of hand-written launches (`csrc/splat.cu`).

Replaces no TPU kernel: the JAX package's `splat_spray` is an einsum over
(lobes x H) and (lobes x W) weight matrices left to XLA, and the port's plain
route (`models/shading.py` `_splat_spray_plain`) builds the same matrices,
rounded to bf16, and contracts them with one matrix product. For 32768 puffs
of 6 lobes at 1280x720 that is 1.6 GB of fp32 weights a frame, and nearly all
of them are exactly 0: a lobe's sigma lies in [0.24, 2.2] px, and fp32 `exp`
is 0 below -103.97, so a weight is 0 more than 14.42 sigma from the lobe's
centre. The chain forms only the weights within `WINDOW_SIGMAS` sigma of each
lobe, with the plain route's operations in its order, bins the lobes into
`TILE` x `TILE` pixel tiles, and sums each pixel's products over its tile's
lobes in ascending lobe order, in fp32; the composite is written with the
overlay kept in registers. So every nonzero product is the plain route's, bit
for bit, and only the order of the fp32 sum differs.

The particles' camera-space terms (`shading._spray_view`) come from the plain
route's own code; the chain takes it from there: screen centre, alpha, sigma,
the puff's lobes, the weights and the composite. It allocates its scratch here
with `torch.empty`, sized by the static worst case (every lobe's window over
`TILES_AXIS` x `TILES_AXIS` tiles), so a call makes no host sync and a render
that runs it stays one captured graph. No float is added with atomics: two
calls, and a replay, give the same bits.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

TILE = 16               # csrc/splat.cu kTile
WINDOW_SIGMAS = 16.0    # csrc/splat.cu kWindowSigmas: at 16 sigma the exponent is -128
SIGMA_MAX = 2.2         # the particle's sigma clamp in shading.splat_spray (lobes: x <= 1)
# the most tiles a window overlaps along an axis: it spans at most
# floor(2 x 16 x 2.2) + 1 = 71 pixels
TILES_AXIS = int(2 * WINDOW_SIGMAS * SIGMA_MAX) // TILE + 2
MAX_LOBES = 8           # csrc/splat.cu kMaxLobes
MAX_TILE_ROWS = 65535   # the gather's grid y extent


def lobe_window(centre: torch.Tensor, sigma: torch.Tensor, n: int):
    """(first, last) pixel of an n-pixel axis in each lobe's window, as the
    kernel computes them (first > last: none): the pixels whose centres lie
    within `WINDOW_SIGMAS` sigma of the lobe's centre, in fp32."""
    c = centre - 0.5
    reach = sigma * WINDOW_SIGMAS
    first = torch.ceil(torch.clamp(c - reach, 0.0, float(n))).long()
    last = torch.floor(torch.clamp(c + reach, -1.0, float(n - 1))).long()
    return first, last


def check_inputs(img, view, scales, dissolve, visible, custom_z, boost, lobes, turns) -> None:
    """Raises on what the kernel does not take: shapes, dtypes, devices.

    view: (x, y, z, dist, world_r, tan_half, focal) from `shading._spray_view`;
    lobes: None (the one-lobe gaussian sprite) or the (L, 4) puff table, with
    turns (P, 2)."""
    if img.ndim != 3 or img.shape[-1] != 3 or img.dtype != torch.float32:
        raise ValueError(f"img must be (H, W, 3) float32, got {tuple(img.shape)} {img.dtype}")
    x, y, z, dist, world_r, tan_half, focal = view
    p = x.shape[0] if x.ndim == 1 else -1
    named = dict(x=x, y=y, z=z, dist=dist, world_r=world_r, dissolve=dissolve)
    if custom_z is not None:
        named["custom_z"] = custom_z
    for name, t in named.items():
        if t.ndim != 1 or t.shape[0] != p:
            raise ValueError(f"{name} must be (P,) with P = {p}, got {tuple(t.shape)}")
    named.update(scales=scales, tan_half=tan_half, focal=focal, boost=boost)
    if tuple(scales.shape) != (p, 3):
        raise ValueError(f"scales must be ({p}, 3), got {tuple(scales.shape)}")
    if tan_half.ndim != 0 or focal.ndim != 0 or tuple(boost.shape) != (3,):
        raise ValueError(f"tan_half and focal must be 0-d and boost (3,), got "
                         f"{tuple(tan_half.shape)}, {tuple(focal.shape)}, {tuple(boost.shape)}")
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(visible.shape) != (p,) or visible.dtype != torch.bool:
        raise TypeError(f"visible must be ({p},) bool, got {tuple(visible.shape)} {visible.dtype}")
    named["visible"] = visible
    if lobes is not None:
        lobes = np.asarray(lobes)
        if lobes.ndim != 2 or lobes.shape[1] != 4 or not 1 <= lobes.shape[0] <= MAX_LOBES:
            raise ValueError(f"lobes must be (L, 4) with 1 <= L <= {MAX_LOBES}, got "
                             f"{lobes.shape}")
        if not ((lobes[:, 2] > 0) & (lobes[:, 2] <= 1)).all():
            raise ValueError("a lobe's sigma fraction must lie in (0, 1]: the lobe list is "
                             "sized for sigma <= SIGMA_MAX")
        if turns is None or tuple(turns.shape) != (p, 2) or turns.dtype != torch.float32:
            raise ValueError(f"turns must be ({p}, 2) float32 beside a lobe table")
        named["turns"] = turns
    if img.device.type != "cuda":
        raise ValueError(f"the splat kernel runs on a CUDA device, got {img.device}; "
                         "CPU tensors take shading.splat_spray's plain route")
    for name, t in named.items():
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")


def _launch(img, view, scales, dissolve, visible, custom_z, boost, max_alpha, lobes, turns):
    h, w, _ = img.shape
    x, y, z, dist, world_r, tan_half, focal = (t.contiguous() for t in view)
    p = x.shape[0]
    table = np.zeros((1, 4), np.float32) if lobes is None else np.asarray(lobes, np.float32)
    n = p * table.shape[0]
    capacity = n * TILES_AXIS ** 2
    tiles = -(-w // TILE) * -(-h // TILE)
    if 2 * capacity >= 2 ** 31 or -(-h // TILE) > MAX_TILE_ROWS:
        raise NotImplementedError(f"the splat kernel takes < 2^30 / {TILES_AXIS ** 2} lobes and "
                                  f"<= {MAX_TILE_ROWS} tile rows, got {n} and {-(-h // TILE)}")
    from . import _build
    from ..utils import observability
    dev = img.device
    img = img.contiguous()
    scales = scales.contiguous()
    dissolve = dissolve.contiguous()
    visible = visible.contiguous()
    custom_z = None if custom_z is None else custom_z.contiguous()
    turns = None if lobes is None else turns.contiguous()
    boost = boost.contiguous()
    out = torch.empty_like(img)
    recs = torch.empty((n, 4), dtype=torch.float32, device=dev)
    rects = torch.empty((n, 4), dtype=torch.int32, device=dev)
    bins = torch.empty(3 * tiles + 2, dtype=torch.int32, device=dev)
    lists = torch.empty(2 * capacity, dtype=torch.int32, device=dev)
    host_table = (ctypes.c_float * table.size)(*table.reshape(-1).tolist())
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev), observability.span("kernel.splat"):
        # the chain's launches (memset, setup, scan, scatter, gather) count as one
        _build.launch("splat", "splat_spray", img.data_ptr(), x.data_ptr(), y.data_ptr(),
                      z.data_ptr(), dist.data_ptr(), world_r.data_ptr(), scales.data_ptr(),
                      dissolve.data_ptr(), visible.data_ptr(), ptr(custom_z), ptr(turns),
                      tan_half.data_ptr(), focal.data_ptr(), boost.data_ptr(), host_table,
                      table.shape[0], p, h, w, h / w, max_alpha, recs.data_ptr(),
                      rects.data_ptr(), bins.data_ptr(), lists.data_ptr(), capacity,
                      out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out


def spray_composite(img, view, scales, dissolve, visible, custom_z, boost, max_alpha: float,
                    lobes=None, turns=None) -> torch.Tensor:
    """The spray composited onto img (H, W, 3) fp32 on the card -> (H, W, 3).

    view: the particles' camera-space terms (`shading._spray_view`); scales
    (P, 3), dissolve (P,), visible (P,) bool, custom_z (P,) or None; boost (3,)
    the foam colour's boost; lobes: None for one gaussian lobe a particle, or
    the (L, 4) puff table (`shading._puff_lobes`) with turns (P, 2), each
    particle's golden-angle cos and sin (`shading._lobe_turns`). The result is
    `shading._splat_spray_plain`'s within the fp32 sum's order. A row whose
    lobe centre, sigma or amplitude is NaN turns the whole composite NaN, as in
    the plain route's contraction, where every sum meets that row's NaN
    products; a lobe whose amplitude is 0 or whose centre is infinite adds only
    zeros and is skipped.
    """
    check_inputs(img, view, scales, dissolve, visible, custom_z, boost, lobes, turns)
    return _launch(img, view, scales, dissolve, visible, custom_z, boost, max_alpha, lobes,
                   turns)
