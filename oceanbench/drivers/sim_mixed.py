"""A session of mixed map sizes: `Ocean.update(dt)` in a closed loop, the maps left on the device.

What a game or engine runs that renders the maps itself and gives each
cascade only the resolution its detail needs: one `Ocean`, reached through
`program.entry("Ocean")`, with one map size a cascade (`map_sizes`). A tick
is one update, which steps each size group; `frame_ms` is the window over
the updates it completed.

In a traced run's instrumented window the program's own trace is on
(`utils.observability.tracing`), and its snapshot over that window goes
into `Records.facts["observability"]` for the readers of the group issue
and the launch count. A program without that API, or without the spans
and counters the readers look for, leaves them nothing to read.

The judge holds each sampled tick's maps and foam a size group at a time
and compares each group with its own `RefGroup` (`reference/mixed.py`)
through `Judge`; a sample's number is the worst over the groups.
"""
from __future__ import annotations

import contextlib
import math

from oceanbench.core import program, records, spec
from oceanbench.core.judge import Judge, Sample
from oceanbench.core.stepper import Stepper


class Driver(Stepper):
    def setup(self) -> None:
        cfg = self.config
        self.ocean = program.entry("Ocean")(
            params=program.cascades(cfg, self.seed, self.device),
            map_size=tuple(cfg["map_sizes"]), updates_per_second=cfg["updates_per_second"],
            device=self.device, map_dtype=cfg["map_dtype"], depth=cfg["depth"], g=cfg["g"])
        self.rec.mark("Ocean init")
        self._trace = None
        self.warm_updates(self.workload["warmup_ticks"])

    def update(self, tick: int | None):
        """One `Ocean.update` in the `update` span; a sampled tick holds, a
        group at a time, the foam it started from, its maps and its foam."""
        sample = tick is not None and tick in self.sample_ticks
        states_in = self.ocean.state if sample else None
        with self.rec.span("update"):
            maps = self.ocean.update(self.dt)
        if sample:
            self.held[tick] = [
                Sample(tick=tick, update=self.updates, foam_in=s.foam,
                       maps=(m.displacement, m.normal), foam_out=out.foam)
                for s, m, out in zip(states_in, maps, self.ocean.state)]
            for s, m, out in zip(states_in, maps, self.ocean.state):
                self.rec.hold(s.foam, m.displacement, m.normal, out.foam)
        self.updates += 1
        return maps

    def tick(self) -> None:
        if self._trace is None and self.rec.mode == records.INSTRUMENTED:
            self._start_trace()
        self.update(self.tick_index)
        self.tick_index += 1
        self.ticks_done = self.tick_index
        self.rec.frames += 1

    def _start_trace(self) -> None:
        self._trace = contextlib.ExitStack()
        try:
            self._snapshot = program.entry("utils.observability.snapshot")
            program.entry("utils.observability.reset")()
            self._trace.enter_context(program.entry("utils.observability.tracing")())
        except (ImportError, AttributeError):
            self._snapshot = None

    def drain(self) -> None:
        """The end of a window: the instrumented one's trace is read and closed."""
        if self._trace is not None and self.rec.mode == records.INSTRUMENTED:
            if self._snapshot is not None:
                self.rec.facts["observability"] = self._snapshot()
            self._trace.close()

    def release(self) -> None:
        self.ocean = None
        if self._trace is not None:
            self._trace.close()

    def reference(self):
        from oceanbench.reference.mixed import RefMixed
        return RefMixed(self.config, spec.cascade_specs(self.config, self.seed), self.dt,
                        self.device)

    def judge(self, control: bool = False) -> list:
        ticks = [t for t in sorted(self.held) if t < self.ticks_done]
        worst = {t: {} for t in ticks}
        for g, ref in enumerate(self.reference().groups):
            samples = [self.held[t][g] for t in ticks]
            for tick, nums in Judge(ref, control=control).maps(
                    samples, self.workload["judge"]["replay_ticks"]):
                for name, value in nums.items():
                    value = value if math.isfinite(value) else math.inf   # fails the verdict
                    worst[tick][name] = max(worst[tick].get(name, value), value)
        return [(t, worst[t]) for t in ticks]
