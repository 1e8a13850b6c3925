"""The simulation alone: `Ocean.update(dt)` in a closed loop, the maps left on the device.

What an engine that renders the maps itself runs. A tick is one update;
`frame_ms` is the window over the updates it completed.
"""
from __future__ import annotations

from oceanbench.core.stepper import Stepper


class Driver(Stepper):
    def setup(self) -> None:
        self.make_ocean()
        self.warm_updates(self.workload["warmup_ticks"])

    def tick(self) -> None:
        self.update(self.tick_index)
        self.tick_index += 1
        self.ticks_done = self.tick_index
        self.rec.frames += 1

    def drain(self) -> None:
        pass
