"""The reference scene's frame loop, closed and uncapped, as a game or a viewer drives it.

Each tick: `Ocean.update(dt)`, `SpraySession.advance`, `SceneRenderer.render`
with the spray (a replayed CUDA graph on the card), then
`FramePipeline.push`, which hands back the previous frame as uint8 in host
memory. A tick of the window is one frame delivered; the camera pans on
the seeded path of `spec.camera_path`. The render and the advance are
spans with device time (CUDA events) in a traced run.
"""
from __future__ import annotations

import numpy as np

from oceanbench.core import program, spec
from oceanbench.core.judge import Judge, frame_numbers
from oceanbench.core.stepper import Stepper


class Driver(Stepper):
    def setup(self) -> None:
        self.make_ocean()
        self.spray = program.spray_session(self.config, self.device)
        self.renderer = program.renderer(self.config, self.workload)
        self.pipe = program.frame_pipeline()
        self.pose = spec.camera_path(self.workload, self.seed)
        self.scales = self.ocean.params.map_scales()
        self.wc = np.asarray(self.config["water_color"], np.float32)
        self.fc = np.asarray(self.config["foam_color"], np.float32)
        self._delivered = 0
        self.rec.mark("spray, renderer and pipeline init")
        for _ in range(self.workload["warmup_ticks"]):
            self._frame(None)
        self.pipe.flush()
        self.rec.mark("warm-up frames")

    def _frame(self, tick):
        maps = self.update(tick)
        sample = self.held.get(tick) if tick is not None else None
        if sample is not None:
            sample.spray_in = self.spray._state
        with self.rec.span("spray", device=True):
            attrs = self.spray.advance(maps, self.scales, self.dt)
        pose = self.pose(self.updates - 1)
        pos, pitch, yaw, fov = pose
        with self.rec.span("render", device=True):
            img = self.renderer.render(maps, self.scales, self.wc, self.fc, pos, pitch, yaw,
                                       spray_attrs=attrs, fov=fov)
        if sample is not None:
            sample.attrs, sample.pose = attrs, pose
            self.rec.hold(*vars(sample.spray_in).values(), *attrs.values())
        return self.pipe.push(img)

    def _deliver(self, host) -> None:
        if host is None:
            return
        self.rec.arrived()
        sample = self.held.get(self._delivered)
        if sample is not None:
            sample.frame = host
        self._delivered += 1
        self.ticks_done = self._delivered

    def tick(self) -> None:
        with self.rec.span("tick"):
            host = self._frame(self.tick_index)
        self.tick_index += 1
        self._deliver(host)

    def drain(self) -> None:
        self._deliver(self.pipe.flush())

    def release(self) -> None:
        self.spray = self.renderer = self.pipe = None
        super().release()

    def judge(self, control: bool = False) -> list:
        samples = [self.held[t] for t in sorted(self.held) if t < self.ticks_done]
        return frame_numbers(Judge(self.reference(), control=control), samples,
                             self.workload["judge"]["replay_ticks"], self.config, self.workload)
