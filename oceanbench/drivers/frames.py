"""Frames baked ahead in blocks: `step_frames(config, state, params, dt, K)` in a closed loop.

What an engine or tool runs that bakes the ocean on the card ahead of its
use: the program's functional entry, reached through `program.entry`, on
the state that `init_state` builds from the configuration's cascades. A
tick is one call of K frames; the state is chained from call to call, and
all K frames' maps (C, K, 3|4, N, N) stay on the device until the next call
has returned. No host sync in the loop. `frame_ms` is the window over the
frames it completed (K a tick); a traced run's `update` span is one call.

The judge (`core/frames_judge.py`) holds, for each sampled call, the foam
it started from, copies (not views, which would keep the whole block
alive) of the frames that `held_frames` names, and its final foam. The
previous call's block is freed before the copies are made, and each copy is
held as it is made, so that the device's peak stays the loop's own.
"""
from __future__ import annotations

from oceanbench.core import program, spec
from oceanbench.core.frames_judge import CallSample, call_numbers, held_frames
from oceanbench.core.judge import Judge
from oceanbench.core.stepper import Stepper


class Driver(Stepper):
    def setup(self) -> None:
        cfg = self.config
        self.frames = int(self.workload["frames"])
        sim_config = program.entry("models.cascade.SimConfig")
        self.sim = sim_config(map_size=cfg["map_size"], map_dtype=cfg["map_dtype"],
                              depth=cfg["depth"], g=cfg["g"])
        self.params = program.cascades(cfg, self.seed, self.device)
        self.state = program.entry("models.ocean.init_state")(self.sim, self.params)
        self.step_frames = program.entry("models.ocean.step_frames")
        self.maps = None
        self.rec.mark("cascades and state init")
        for _ in range(self.workload["warmup_ticks"]):
            self.call(None)
        self.rec.mark("warm-up calls")

    def call(self, tick: int | None) -> None:
        """One call of `step_frames` in the `update` span; `tick` is the
        window tick (None in set-up)."""
        state_in = self.state
        with self.rec.span("update"):
            self.state, maps = self.step_frames(self.sim, state_in, self.params, self.dt,
                                                self.frames)
        self.maps = maps          # the previous call's block is freed only now
        if tick is not None and tick in self.sample_ticks:
            frames = {}
            for k in held_frames(self.seed, tick, self.frames,
                                 whole=tick < self.workload["judge"]["replay_ticks"]):
                frames[k] = (maps.displacement[:, k].clone(), maps.normal[:, k].clone())
                self.rec.hold(*frames[k])
            self.held[tick] = CallSample(tick=tick, first=self.updates, foam_in=state_in.foam,
                                         frames=frames, foam_out=self.state.foam)
            self.rec.hold(state_in.foam, self.state.foam)
        self.updates += self.frames

    def tick(self) -> None:
        self.call(self.tick_index)
        self.tick_index += 1
        self.ticks_done = self.tick_index
        self.rec.frames += self.frames

    def drain(self) -> None:
        pass

    def release(self) -> None:
        self.state = self.params = self.maps = self.step_frames = None

    def reference(self):
        from oceanbench.reference.frames import RefFrames
        return RefFrames(self.config, spec.cascade_specs(self.config, self.seed), self.dt,
                         self.frames, self.device)

    def judge(self, control: bool = False) -> list:
        samples = [self.held[t] for t in sorted(self.held) if t < self.ticks_done]
        return call_numbers(Judge(self.reference(), control=control), samples,
                            self.workload["judge"]["replay_ticks"], self.frames)
