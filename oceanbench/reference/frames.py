"""The reference of a call of `step_frames`: `RefOcean` on the clock of a call of K frames.

`Ocean.update` adds dt to each cascade's fp32 time once an update. A call of
`step_frames` (the multi-frame kernel's contract, and the JAX package's
`_step_frames_impl`) does not: a call that starts at time T modulates its
frame k at (T + dt) + k dt and ends at T + dt K, each operation rounded to
fp32 in this order:

    t_k = fl(fl(T + dt) + fl(k dt)),    T' = fl(T + fl(dt K))

Over a window of some 1,700 calls the two clocks part by ulps of t (~1e-4 s
near its end): ~0.01 rad of phase at the 16 m cascade's highest wavenumber,
close to what `maps_max` allows. So this reference keeps the call's clock;
the run's update u = K b + k is frame k of call b (warm-up calls counted).

Plain NumPy and PyTorch; imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from .ocean import RefOcean


class RefFrames(RefOcean):
    """`RefOcean` whose update u is frame u mod `frames` of call u // `frames`."""

    def __init__(self, config: dict, specs: list, dt: float, frames: int, device):
        super().__init__(config, specs, dt, device)
        self.frames = int(frames)
        self._call_dt = np.float32(self.dt32 * np.float32(self.frames))
        self._starts = [np.asarray(self.t0, np.float32)]

    def start(self, call: int) -> np.ndarray:
        """Each cascade's fp32 time when call `call` of the run starts."""
        while len(self._starts) <= call:
            self._starts.append((self._starts[-1] + self._call_dt).astype(np.float32))
        return self._starts[call]

    def time(self, update: int) -> np.ndarray:
        """Each cascade's fp32 time that the run's update `update` modulates at."""
        call, k = divmod(update, self.frames)
        first = (self.start(call) + self.dt32).astype(np.float32)
        return (first + np.float32(np.float32(k) * self.dt32)).astype(np.float32)
