"""The host clock's readings of a run and their statistics.

`process_start` reads when this process began, so that the set-up time
counts the interpreter's start too. (Device time is read by CUDA events
around calls, `records.py`, the pattern of `bench_torch.py`'s `Window`.)
"""
from __future__ import annotations

import os
import statistics
import time


def process_start() -> float:
    """The `time.perf_counter()` reading at which this process started
    (from /proc, to the kernel's 10 ms tick), or now where /proc is absent."""
    now_pc, now_boot = time.perf_counter(), time.clock_gettime(time.CLOCK_BOOTTIME)
    try:
        with open(f"/proc/{os.getpid()}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now_pc
    return now_pc - (now_boot - started)


def window_ms(t_start: float, t_end: float, frames: int) -> float:
    """The whole window's time over the frames it completed, in ms."""
    return (t_end - t_start) * 1e3 / frames


def intervals_ms(arrivals: list) -> list:
    """Intervals between consecutive arrivals (host-clock seconds), in ms."""
    return [(b - a) * 1e3 for a, b in zip(arrivals, arrivals[1:])]


def p95(values: list) -> float:
    """The 95th percentile, `statistics.quantiles`' inclusive method."""
    if len(values) < 2:
        raise ValueError(f"a 95th percentile needs 2 values or more, got {len(values)}")
    return statistics.quantiles(values, n=100, method="inclusive")[94]
