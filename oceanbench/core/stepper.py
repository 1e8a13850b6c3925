"""What every driver shares: the session, the ticks the judge samples, and the step's samples.

A driver subclasses `Stepper`, builds what else its mix needs in `setup`,
and calls `update()` once a tick: `Ocean.update(dt)` inside the `update`
span, holding the state that a sampled tick started from and the maps and
foam it produced.
"""
from __future__ import annotations

from . import program, spec
from .judge import Judge, Sample


class Stepper:
    def __init__(self, cell, seed: int, device, rec):
        self.cell, self.seed, self.device, self.rec = cell, seed, device, rec
        self.config, self.workload = cell.config, cell.workload
        self.dt = float(self.workload["dt"])
        self.sample_ticks = spec.sample_ticks(self.workload, seed)
        self.held: dict[int, Sample] = {}
        self.ticks_done = 0          # window ticks whose outputs are complete
        self.updates = 0             # every update of the run, warm-up included
        self.tick_index = 0          # window ticks begun
        self.ocean = None

    def make_ocean(self):
        self.ocean = program.ocean(self.config, self.seed, self.device)
        self.rec.mark("Ocean init")

    def warm_updates(self, count: int) -> None:
        """Set-up updates: outside the window, not sampled."""
        for _ in range(count):
            self.ocean.update(self.dt)
            self.updates += 1
        self.rec.mark("warm-up updates")

    def update(self, tick: int | None):
        """One `Ocean.update` in the `update` span; `tick` is the window tick
        it belongs to (None in set-up). Returns the maps."""
        sample = tick is not None and tick in self.sample_ticks
        state_in = self.ocean.state if sample else None
        with self.rec.span("update"):
            maps = self.ocean.update(self.dt)
        if sample:
            self.held[tick] = Sample(tick=tick, update=self.updates, foam_in=state_in.foam,
                                     maps=(maps.displacement, maps.normal),
                                     foam_out=self.ocean.state.foam)
            self.rec.hold(state_in.foam, maps.displacement, maps.normal, self.ocean.state.foam)
        self.updates += 1
        return maps

    def release(self) -> None:
        """Drop the program's session; the held samples stay."""
        self.ocean = None

    def reference(self):
        from oceanbench.reference.ocean import RefOcean
        return RefOcean(self.config, spec.cascade_specs(self.config, self.seed), self.dt,
                        self.device)

    def judge(self, control: bool = False) -> list:
        samples = [self.held[t] for t in sorted(self.held) if t < self.ticks_done]
        judge = Judge(self.reference(), control=control)
        return judge.maps(samples, self.workload["judge"]["replay_ticks"])
