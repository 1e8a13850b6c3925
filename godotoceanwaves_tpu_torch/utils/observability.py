"""Observability: the program's spans and counters, rolling frame statistics
and the text panel.

Counterpart of the JAX package's `utils/observability.py`. The reference's
only observability is the ImGui FPS/ms overlay (main.gd:58-64) plus live
parameter readouts:

  * span(name) / count(name, n): the program's own trace. Each layer of the
    port marks its work with a span named `<layer>.<what>` (`ocean.update`,
    `step.scalars`, `kernel.fused_step`, `graph.launch`, `pipeline.wait`,
    `stream.convert`, ...) and counts what a span's count does not tell
    where it happens (`graph.copy_in_bytes`, `pipeline.bytes`, and
    `launches.<op>`: the kernel launches, counted where `ops/_build.py`
    counts them in its `LAUNCHES`).
  * FrameStats: rolling per-update wall-clock statistics (FPS, ms percentiles)
  * panel(): a text rendering of the live state, the ImGui panel as a string.
    It shows the session's step tier (`SimConfig.step_tier()`) where the JAX
    package shows its FFT tier: the port has no `fft_impl`.

Tracing is on while a `torch.profiler` session records
(`torch.autograd.profiler._is_profiler_enabled`) and inside a `tracing()`
block; nothing else turns it on. Off, `span` returns a shared no-op and
`count` returns at once: neither reads a clock, enters a profiler range
or keeps a record. On, each span records its name, start and end
(`time.perf_counter_ns`, the host clock of `time.perf_counter`), its parent
(the span open on the same thread) and its thread, in a ring of the last
`RING` spans and in per-name totals (count, host ms, self ms: the span less
the time its children cover); counters add up; and while a profiler records,
each span is also a profiler range of the same name, so the profiler's
trace holds it on its own timeline, beside the device's. The range is
`torch._C._profiler._RecordFunctionFast`, the one torch's generated code
enters: a host op of the trace, a seventh of `record_function`'s cost
(~2 µs against ~15 on a slow CPU), and no `gpu_user_annotation` shadow on
the device's timeline for a reader to mistake for an operation.

`snapshot()` returns the totals and the counters; `reset()` clears them.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _profiler

RING = 65_536                       # spans the ring keeps

_depth = 0                          # open tracing() blocks


class SpanRecord(NamedTuple):
    name: str
    start_ns: int                   # time.perf_counter_ns()
    end_ns: int
    parent: str | None              # the span open on this thread when it began
    thread: int                     # threading.get_ident()


class _Off:
    """The span of tracing off: enters and leaves, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that records the block as the span `name` while
    tracing is on; a shared no-op otherwise."""
    if _depth or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while tracing is on."""
    if _depth or _profiler._is_profiler_enabled:
        _recorder.add(name, n)


class _Span:
    __slots__ = ("name", "parent", "child_ns", "t0", "range", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.stack = _recorder.stack()
        self.parent = self.stack[-1] if self.stack else None
        self.child_ns = 0
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.t0 = time.perf_counter_ns()
            self.range.__enter__()
        else:
            self.t0 = time.perf_counter_ns()
        self.stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        self.stack.pop()
        duration = t1 - self.t0
        if self.parent is not None:
            self.parent.child_ns += duration
        _recorder.left(self, t1, duration)
        return False


class _Recorder:
    """The process's spans and counters (module functions below are its
    interface)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._ring: collections.deque = collections.deque(maxlen=RING)
            self._totals: dict[str, list] = {}      # name -> [count, total ns, self ns]
            self._counters: dict[str, int] = {}

    def stack(self) -> list:
        """This thread's stack of open spans."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def left(self, s: _Span, t1: int, duration: int) -> None:
        record = (s.name, s.t0, t1, None if s.parent is None else s.parent.name,
                  threading.get_ident())
        with self._lock:
            self._ring.append(record)
            total = self._totals.get(s.name)
            if total is None:
                total = self._totals[s.name] = [0, 0, 0]
            total[0] += 1
            total[1] += duration
            total[2] += duration - s.child_ns

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def spans(self) -> list:
        with self._lock:
            return [SpanRecord(*r) for r in self._ring]

    def snapshot(self) -> dict:
        with self._lock:
            ring = list(self._ring)
            totals = {k: list(v) for k, v in self._totals.items()}
            counters = dict(self._counters)
        durations: dict[str, list] = {}
        for name, start, end, _, _ in ring:
            durations.setdefault(name, []).append(end - start)
        spans = {}
        for name, (n, total_ns, self_ns) in sorted(totals.items()):
            ms = np.asarray(durations.get(name, []), np.float64) / 1e6
            spans[name] = {"count": n, "total_ms": total_ns / 1e6, "self_ms": self_ns / 1e6,
                           "mean_ms": total_ns / 1e6 / n,
                           "p50_ms": float(np.percentile(ms, 50)) if ms.size else None,
                           "p99_ms": float(np.percentile(ms, 99)) if ms.size else None}
        return {"spans": spans, "counters": counters}


_recorder = _Recorder()


@contextlib.contextmanager
def tracing():
    """Trace the block without a profiler (an operator's or a test's): every
    thread records while it is open. Nests."""
    global _depth
    with _recorder._lock:
        _depth += 1
    try:
        yield
    finally:
        with _recorder._lock:
            _depth -= 1


def snapshot() -> dict:
    """Per span name: count, total, self, mean, p50 and p99 host ms (the
    percentiles over the spans the ring still holds, None where it holds
    none); and the counters."""
    return _recorder.snapshot()


def spans() -> list:
    """The ring's spans (`SpanRecord`), oldest first."""
    return _recorder.spans()


def reset() -> None:
    """Clear the spans, totals and counters."""
    _recorder.reset()


class FrameStats:
    """Rolling window of frame/update durations (seconds).

    Thread-safe: a viewer may record() from its frame loop while another
    thread calls summary().
    """

    def __init__(self, window: int = 120):
        self._durations = collections.deque(maxlen=window)
        self._last = None
        self._lock = threading.Lock()

    def tick(self) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._last is not None:
                self._durations.append(now - self._last)
            self._last = now

    def record(self, seconds: float) -> None:
        with self._lock:
            self._durations.append(seconds)

    @property
    def fps(self) -> float:
        with self._lock:
            snap = list(self._durations)
        if not snap:
            return 0.0
        return 1.0 / max(1e-9, float(np.mean(snap)))

    def summary(self) -> dict[str, float]:
        with self._lock:
            snap = list(self._durations)
        if not snap:
            return {"fps": 0.0, "ms_mean": 0.0, "ms_p50": 0.0, "ms_p99": 0.0}
        ms = np.asarray(snap) * 1e3
        return {
            "fps": self.fps,
            "ms_mean": float(ms.mean()),
            "ms_p50": float(np.percentile(ms, 50)),
            "ms_p99": float(np.percentile(ms, 99)),
        }


PANEL_FIELDS = ("tile_length", "displacement_scale", "normal_scale", "wind_speed",
                "wind_direction", "fetch_length", "swell", "spread", "detail",
                "whitecap", "foam_amount")


def panel(ocean: Any, stats: FrameStats | None = None) -> str:
    """Text rendering of the live parameter/metrics panel (main.gd:57-121).
    Reads each parameter field from the card once."""
    lines = ["=== OceanWaves (PyTorch) ==="]
    if stats is not None:
        s = stats.summary()
        lines.append(f"FPS: {s['fps']:7.1f}  ({s['ms_mean']:.2f} ms mean, "
                     f"p99 {s['ms_p99']:.2f} ms)")
    cfgs = ocean.config if isinstance(ocean.config, tuple) else (ocean.config,)  # mixed sizes
    lines.append(f"Wave Resolution: {', '.join(f'{c.map_size}x{c.map_size}' for c in cfgs)}   "
                 f"Step: {'/'.join(c.step_tier() for c in cfgs)}   maps: {cfgs[0].map_dtype}")
    lines.append(f"Updates/s: {ocean.updates_per_second}   "
                 f"stagger: {ocean.stagger}")
    fields = {name: getattr(ocean.params, name).detach().cpu().numpy()
              for name in PANEL_FIELDS}
    for i in range(ocean.num_cascades):
        lines.append(f"--- Cascade {i + 1} ---")
        for name in PANEL_FIELDS:
            lines.append(f"  {name:20s} {np.round(fields[name][i], 4)}")
    return "\n".join(lines)
