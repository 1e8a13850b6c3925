"""Device timing with CUDA events.

PyTorch returns before the card finishes, so a host clock around launches
measures the enqueue. `time_cuda` records events on the current stream
around `iters` calls, synchronizes, and divides.
"""
from __future__ import annotations

from typing import Callable

import torch


def time_cuda(fn: Callable[[], object], iters: int = 20, warmup: int = 3,
              repeats: int = 3) -> float:
    """Best-of-`repeats` device ms per call of `fn()` on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device; none is available")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best
