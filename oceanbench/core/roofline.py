"""The least time a step's work can take on one H100, counted from shapes.

A copy of `chip_smoke.py`'s `nbytes`, `fft_flops`, `bound` and `step_bound`
arithmetic, counted here from the cell's shapes instead of from tensors, so
that it holds whatever implements the step. Peaks: NVIDIA's H100 SXM data
sheet (dense fp32 outside the tensor cores, HBM3), at the 700 W limit.
"""
from __future__ import annotations

import math

HBM_TBPS = 3.35
FP32_TFLOPS = 67.0
MAP_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
NUM_SCALARS = 8     # the step's per-cascade fp32 scalar row


def fft_flops(n: int, transforms: int) -> float:
    """5 n log2 n flops per length-n complex transform."""
    return 5.0 * n * math.log2(n) * transforms


def bound(moved: float, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and flops over the fp32 rate."""
    t_bytes = moved / (HBM_TBPS * 1e9)
    t_ops = flops / (FP32_TFLOPS * 1e9)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_bytes(cascades: int, n: int, map_dtype: str) -> int:
    """A step's state in and maps and foam out, each byte once: h0 and
    conj(h0(-k)) as fp32 plane pairs, omega and foam fp32 in; displacement
    (3 channels) and normal (4) in the map dtype and foam fp32 out; the
    scalar rows in."""
    texel_in = 2 * 4 + 2 * 4 + 4 + 4
    texel_out = 7 * MAP_BYTES[map_dtype] + 4
    return cascades * (n * n * (texel_in + texel_out) + NUM_SCALARS * 4)


def step_bound(cascades: int, n: int, map_dtype: str) -> tuple[float, str]:
    """A whole step's bound: its bytes, and the operations of the 2D IFFT of
    4 layers a cascade (2 n transforms of length n a layer; modulate and
    unpack not counted)."""
    return bound(step_bytes(cascades, n, map_dtype), fft_flops(n, cascades * 4 * 2 * n))


def frames_bytes(cascades: int, n: int, map_dtype: str, frames: int) -> int:
    """A call of `frames` frames, each byte once: the spectra, omega and
    foam in once (24 B a texel), every frame's displacement and normal out
    in the map dtype (7 channels a texel), the final foam out once (4 B a
    texel), and the scalar rows in. The spectra are fetched once a cascade
    for the whole call."""
    texel_in = 2 * 4 + 2 * 4 + 4 + 4
    texel_out = frames * 7 * MAP_BYTES[map_dtype] + 4
    return cascades * (n * n * (texel_in + texel_out) + NUM_SCALARS * 4)


def frames_bound(cascades: int, n: int, map_dtype: str, frames: int) -> tuple[float, str]:
    """A frame's share of the least time of a call of `frames` frames: the
    call's bytes, and `frames` times a step's FFT operations, over
    `frames`."""
    least, by = bound(frames_bytes(cascades, n, map_dtype, frames),
                      frames * fft_flops(n, cascades * 4 * 2 * n))
    return least / frames, by
