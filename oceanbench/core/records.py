"""What a run records for its metric readers.

The drivers mark the calls they make into the program's layers with
`records.span(name)`. What a span records depends on the part of the run:

- the measured window of `--trace 0`: nothing (a span is free);
- the window of `--trace 1`: the host clock around the call (`host_ms`),
  and CUDA events around it where the driver asks for device time
  (`device_ms`, resolved after the window's synchronize);
- the profiled window that follows it: a `record_function` span named
  `oceanbench.<name>`, which `trace.summarize` reads.

The drivers `hold` the device tensors that they keep for the judge, so
that the device's peak is read without them: the allocator's peak is
closed at each change to what is held, less the bytes held until then.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

TIMED, INSTRUMENTED, PROFILED = "timed", "instrumented", "profiled"


@dataclasses.dataclass
class Records:
    cell: object                         # manifest.Cell
    seed: int
    seconds: float
    torch: object = None
    device: object = None                # torch.device of the run
    mode: str = TIMED
    setup_s: float | None = None
    t_start: float | None = None         # the window's host-clock start
    t_end: float | None = None           # ... and end, after its synchronize
    frames: int = 0                      # frames the window completed
    arrivals: list = dataclasses.field(default_factory=list)   # host arrival times
    host_ms: dict = dataclasses.field(default_factory=dict)    # span -> [ms]
    device_ms: dict = dataclasses.field(default_factory=dict)  # span -> [ms]
    window_peak_bytes: int | None = None
    trace: dict | None = None            # trace.summarize's numbers
    facts: dict = dataclasses.field(default_factory=dict)      # the driver's counts
    _events: dict = dataclasses.field(default_factory=dict)
    _marks: list = dataclasses.field(default_factory=list)     # (phase, host time it ended)
    _held: dict = dataclasses.field(default_factory=dict)      # storage pointer -> bytes
    _peak: int = 0                       # the allocator's peak less what was held, so far

    def mark(self, phase: str, at: float | None = None) -> None:
        """A phase of set-up ended now (or at `at`, a host-clock reading)."""
        self._marks.append((phase, time.perf_counter() if at is None else at))

    def phases(self, started: float) -> list:
        """(phase, seconds) of the set-up from the process start."""
        out, last = [], started
        for phase, at in self._marks:
            out.append((phase, at - last))
            last = at
        return out

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def peak_less_held(self) -> int:
        """The allocator's peak since the last reading, less the bytes held
        for the judge in that time, folded into the peak so far; then a
        reset of the allocator's peak."""
        if self._on_card():
            cuda = self.torch.cuda
            now = cuda.max_memory_allocated(self.device) - sum(self._held.values())
            self._peak = max(self._peak, now)
            cuda.reset_peak_memory_stats(self.device)
        return self._peak

    def _storages(self, tensors) -> dict:
        return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if isinstance(t, self.torch.Tensor) and t.device.type == "cuda"}

    def hold(self, *tensors) -> None:
        """The judge keeps these device tensors past the program's use of them."""
        if self._on_card():
            self.peak_less_held()
            self._held.update(self._storages(tensors))

    def unhold(self, *tensors) -> None:
        if self._on_card():
            self.peak_less_held()
            for ptr in self._storages(tensors):
                self._held.pop(ptr, None)

    def arrived(self) -> None:
        """A frame reached host memory now."""
        self.arrivals.append(time.perf_counter())
        self.frames += 1

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False):
        if self.mode == TIMED:
            yield
            return
        if self.mode == PROFILED:
            with self.torch.autograd.profiler.record_function(f"oceanbench.{name}"):
                yield
            return
        if device:
            start = self.torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield
        self.host_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        if device:
            end = self.torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.setdefault(name, []).append((start, end))

    def resolve_events(self) -> None:
        """After a synchronize: the CUDA event pairs as device ms by span."""
        for name, pairs in self._events.items():
            self.device_ms.setdefault(name, []).extend(a.elapsed_time(b) for a, b in pairs)
        self._events.clear()
