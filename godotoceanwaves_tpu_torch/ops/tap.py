"""The render's LOD gradient taps: every band and cascade of a frame in one launch.

Replaces `godotoceanwaves_tpu/ops/pallas_tap.py` `fused_tap` (the Pallas
kernels `_tap_kernel_linear` and `_tap_kernel_blend`), which the JAX package
reaches from `shading._slab_tap` / `_gradient_tap` inside
`cascade_gradient_lod`: a `lax.scan` over bands, a `lax.switch` over the
band's mip level and slab window, a `lax.cond` between the linear tap and
the bicubic/bilinear blend, one kernel call per (band, cascade). Eager
PyTorch would read those choices on the host, one sync per (band, cascade).
The kernel in `csrc/tap.cu` takes them on the device instead: a block per
(band, slice of pixels) reads the band's levels once, skips a cascade at
the skip value, and each thread taps the full mip level circularly (2x2
texels, or 4x4 for the blend), with the TPU kernel's weights (circular
distance, rounded to bf16) and fp32 sums. A slab window of the v-duplicated
table holds the same texels at the same fp32 distances, so no window is
built.

A wrapper call is one launch: the kernel reads the caller's levels in place
(fp32, as the renderer builds them, or bf16; each texel rounded to bf16 as
it is loaded) through a table of level pointers, and `xz_bands` by its
strides. On a CPU tensor `gradient_lod_tap` runs the plain version, the JAX
package's einsum taps in `models/shading.py` (`cascade_gradient_lod` with
tap_impl="einsum"). The kernel is bound by the texels its taps touch, its 2
floats in and its 3 floats out a pixel; a pixel's arithmetic is a few
hundred flops.
"""
from __future__ import annotations

import ctypes

import torch

MAX_LEVELS = 16         # csrc/tap.cu kMaxLevels: 8192^2 down to 8^2 needs 11
MAX_BANDS = 65535       # the grid's y extent


def check_inputs(pyramid, map_scales, xz_bands, band_levels) -> None:
    """Raises on what neither version takes: shapes, dtypes, devices."""
    if not pyramid:
        raise ValueError("pyramid must hold at least one level")
    c, ch, r, r2 = pyramid[0].shape
    if ch != 3 or r != r2:
        raise ValueError(f"pyramid level 0 must be (C, 3, R, R), got {tuple(pyramid[0].shape)}")
    for lev, p in enumerate(pyramid):
        n = r >> lev
        if tuple(p.shape) != (c, 3, n, n) or n << lev != r:
            raise ValueError(f"pyramid level {lev} must be (C, 3, R >> {lev}, R >> {lev}) = "
                             f"{(c, 3, n, n)}, got {tuple(p.shape)}")
        if p.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"pyramid levels must be float32 or bfloat16, got {p.dtype}")
        if p.dtype != pyramid[0].dtype:
            raise TypeError(f"pyramid levels must share one dtype: level 0 is "
                            f"{pyramid[0].dtype}, level {lev} {p.dtype}")
        if p.device != xz_bands.device:
            raise ValueError(f"pyramid level {lev} is on {p.device}, xz_bands on "
                             f"{xz_bands.device}")
    if xz_bands.ndim != 3 or xz_bands.shape[-1] != 2:
        raise ValueError(f"xz_bands must be (B, P, 2), got {tuple(xz_bands.shape)}")
    if xz_bands.dtype != torch.float32 or map_scales.dtype != torch.float32:
        raise TypeError(f"xz_bands and map_scales must be float32, got {xz_bands.dtype} and "
                        f"{map_scales.dtype}")
    if tuple(map_scales.shape) != (c, 4):
        raise ValueError(f"map_scales must be ({c}, 4), got {tuple(map_scales.shape)}")
    if tuple(band_levels.shape) != (xz_bands.shape[0], c):
        raise ValueError(f"band_levels must be ({xz_bands.shape[0]}, {c}), got "
                         f"{tuple(band_levels.shape)}")
    if band_levels.dtype != torch.int32:
        raise TypeError(f"band_levels must be int32, got {band_levels.dtype}")
    for name, t in (("map_scales", map_scales), ("band_levels", band_levels)):
        if t.device != xz_bands.device:
            raise ValueError(f"{name} is on {t.device}, xz_bands on {xz_bands.device}")


def gradient_lod_tap_reference(pyramid, map_scales, xz_bands, band_levels) -> torch.Tensor:
    """Plain version: the JAX package's band scan of einsum taps."""
    from ..models import shading
    return shading.cascade_gradient_lod(pyramid, map_scales, xz_bands, band_levels,
                                        tap_impl="einsum")


def _launch(pyramid, map_scales, xz_bands, band_levels) -> torch.Tensor:
    b, p, _ = xz_bands.shape
    c, _, r, _ = pyramid[0].shape
    if len(pyramid) > MAX_LEVELS or b > MAX_BANDS or b * p >= 2 ** 31:
        raise NotImplementedError(f"the gradient-tap kernel takes <= {MAX_LEVELS} levels, "
                                  f"<= {MAX_BANDS} bands and < 2^31 pixels, got "
                                  f"{len(pyramid)}, {b} and {b * p}")
    from . import _build
    from ..utils import observability
    dev = xz_bands.device
    levels = [lev.contiguous() for lev in pyramid]          # no copy where contiguous
    scales = map_scales.contiguous()
    band_lev = band_levels.contiguous()
    out = torch.empty((b, p, 3), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(levels))(*[lev.data_ptr() for lev in levels])
    with torch.cuda.device(dev), observability.span("kernel.tap"):
        _build.launch("tap", "lod_tap", ptrs, len(levels),
                      int(levels[0].dtype == torch.bfloat16), scales.data_ptr(),
                      xz_bands.data_ptr(), *xz_bands.stride(), band_lev.data_ptr(),
                      out.data_ptr(), b, p, c, r, torch.cuda.current_stream(dev).cuda_stream)
    return out


def gradient_lod_tap(pyramid: list, map_scales: torch.Tensor, xz_bands: torch.Tensor,
                     band_levels: torch.Tensor) -> torch.Tensor:
    """Banded, mip-selected gradient taps summed over cascades -> (B, P, 3).

    pyramid: list of (C, 3, R >> l, R >> l) levels of one dtype, float32
    or bf16 (`shading.normal_gradient_pyramid`); map_scales (C, 4) float32;
    xz_bands (B, P, 2) float32 world xz; band_levels (B, C) int32, where
    len(pyramid) skips the cascade. A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version.
    """
    check_inputs(pyramid, map_scales, xz_bands, band_levels)
    if xz_bands.device.type == "cuda":
        return _launch(pyramid, map_scales, xz_bands, band_levels)
    if xz_bands.device.type != "cpu":
        raise ValueError(f"unsupported device {xz_bands.device}")
    return gradient_lod_tap_reference(pyramid, map_scales, xz_bands, band_levels)
