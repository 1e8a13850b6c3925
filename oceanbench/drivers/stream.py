"""Config 5's host consumer: `MapStreamer` over `Ocean.update(dt)`, frames consumed as they arrive.

A tick is one set of maps delivered to host memory as the streamer yields
it (its host dtype, converted on the host after the copy). The streamer's
step runs ahead of the delivery by up to its `max_inflight` frames; a
window's ticks are numbered in delivery order, and the judge compares the
host arrays as delivered.
"""
from __future__ import annotations

import collections

import torch

from oceanbench.core import program
from oceanbench.core.stepper import Stepper

ENDLESS = 1 << 62


class Driver(Stepper):
    def setup(self) -> None:
        self.make_ocean()
        self._producing = collections.deque()     # window ticks produced, not yet delivered
        self._gen = None
        self._warm = True
        self.streamer = program.map_streamer(self._step, self.config)
        for _ in self.streamer.stream(num_frames=self.workload["warmup_ticks"]):
            pass
        self._warm = False
        self.rec.mark("streamer warm-up")
        c, n = len(self.config["cascades"]), self.config["map_size"]
        map_bytes = {"float32": 4, "bfloat16": 2, "float16": 2}[self.config["map_dtype"]]
        self.rec.facts["frame_bytes"] = c * 7 * n * n * map_bytes

    def _step(self):
        if self._warm:
            self.updates += 1
            return self.ocean.update(self.dt)
        tick = self.tick_index
        self.tick_index += 1
        self._producing.append(tick)
        return self.update(tick)

    def tick(self) -> None:
        if self._gen is None:
            self._gen = self.streamer.stream(num_frames=ENDLESS)
        with self.rec.span("deliver"):
            host = next(self._gen)
        self.rec.arrived()
        tick = self._producing.popleft()
        sample = self.held.get(tick)
        if sample is not None:
            self.rec.unhold(*sample.maps)
            sample.maps = (torch.as_tensor(host["displacement"]),
                           torch.as_tensor(host["normal"]))
        self.ticks_done = tick + 1

    def drain(self) -> None:
        """Close the window's stream: the frames produced and not delivered
        are dropped, and their ticks are produced again by the next stream."""
        if self._gen is not None:
            self._gen.close()
            self._gen = None
        for tick in self._producing:
            dropped = self.held.pop(tick, None)
            if dropped is not None:
                self.rec.unhold(dropped.foam_in, *dropped.maps, dropped.foam_out)
        self._producing.clear()
        self.tick_index = self.ticks_done

    def release(self) -> None:
        self.streamer.close()
        self.streamer = None
        super().release()
