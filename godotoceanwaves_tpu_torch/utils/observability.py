"""Observability: rolling frame statistics, stage timers and the text panel.

Counterpart of the JAX package's `utils/observability.py`. The reference's
only observability is the ImGui FPS/ms overlay (main.gd:58-64) plus live
parameter readouts:

  * FrameStats: rolling per-update wall-clock statistics (FPS, ms percentiles)
  * StageTimer: per-stage host wall time; a stage that should include the
    card's work ends in `torch.cuda.synchronize()` (PyTorch returns before
    the card finishes), and `utils.timing.time_cuda` gives device time
  * panel(): a text rendering of the live state, the ImGui panel as a string.
    It shows the session's step tier (`SimConfig.step_tier()`) where the JAX
    package shows its FFT tier: the port has no `fft_impl`.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any

import numpy as np


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


class StageTimer:
    """Accumulates named stage durations; `with timer("fft"): ...`."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    def __call__(self, name: str):
        return _StageCtx(self, name)

    def summary(self) -> dict[str, float]:
        """Mean ms per entry of each stage."""
        return {k: self.totals[k] / max(1, self.counts[k]) * 1e3
                for k in self.totals}


class _StageCtx:
    def __init__(self, timer: StageTimer, name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.totals[self.name] += time.perf_counter() - self.t0
        self.timer.counts[self.name] += 1
        return False


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
    cfg = ocean.config
    lines.append(f"Wave Resolution: {cfg.map_size}x{cfg.map_size}   "
                 f"Step: {cfg.step_tier()}   maps: {cfg.map_dtype}")
    lines.append(f"Updates/s: {ocean.updates_per_second}   "
                 f"stagger: {ocean.stagger}")
    fields = {name: getattr(ocean.params, name).detach().cpu().numpy()
              for name in PANEL_FIELDS}
    for i in range(ocean.num_cascades):
        lines.append(f"--- Cascade {i + 1} ---")
        for name in PANEL_FIELDS:
            lines.append(f"  {name:20s} {np.round(fields[name][i], 4)}")
    return "\n".join(lines)
