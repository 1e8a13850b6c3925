"""The comparison that decides `correct` for calls of K frames (`step_frames`): frames inside a call.

The multi-frame kernel carries its foam from frame to frame inside a call and
hands back only the last. So for each call that `spec.sample_ticks` draws,
the frames driver holds the fp32 foam the call started from, copies of the
frames that `held_frames` names, and the call's final foam: every frame of
the first `replay_ticks` calls, and of the later ones the first, the last
and every `HOLD_EVERY`-th from an offset drawn from the seed. Once the
window has closed, the reference (`reference/frames.py`, whose clock follows
the call's) chains its own foam through the call's K frames (`Judge.chain`):
from that start foam, or for the first `replay_ticks` calls from zero foam at
the run's first update. Each held frame's maps are compared as
`Judge.numbers` compares an update's, and the final foam against the chain's
after frame K - 1; a sample's numbers are the worst over its frames. The
control chains the same way, one precision lower, in the program's place.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from . import spec
from .judge import Judge, Sample


@dataclasses.dataclass
class CallSample:
    tick: int                  # window tick: one call
    first: int                 # the run's update index of the call's frame 0
    foam_in: torch.Tensor      # (C, N, N) fp32 the call started from
    frames: dict               # frame of the call -> (displacement, normal), (C, 3|4, N, N)
    foam_out: torch.Tensor     # (C, N, N) fp32 the call ended with

HOLD_EVERY = 6      # ~0.5 GB of copies a later call at 4 x 1024^2 bf16, K = 48


def held_frames(seed: int, tick: int, frames: int, whole: bool) -> tuple:
    """The frames of call `tick` that the judge holds: all of them where
    `whole`, else the first, the last and every `HOLD_EVERY`-th from an
    offset in [1, HOLD_EVERY] drawn from the seed."""
    if whole:
        return tuple(range(frames))
    gen = np.random.default_rng([int(seed) & (2 ** 64 - 1), spec.SEED_STREAMS["samples"],
                                 int(tick)])
    offset = 1 + int(gen.integers(HOLD_EVERY))
    return tuple(sorted({0, frames - 1, *range(offset, frames, HOLD_EVERY)}))


def call_numbers(judge: Judge, samples: list, replay_ticks: int, frames: int) -> list:
    """[(tick, {maps_rms, maps_max, foam_rms})] for each sampled call."""
    none = [None] * judge.ref.num_cascades
    out = []
    for s in samples:
        if frames - 1 not in s.frames:
            raise ValueError(f"call {s.tick}: the judge needs the call's last frame")
        wanted = frozenset(s.first + k for k in s.frames)
        start = None if s.tick < replay_ticks else (s.foam_in, s.first)
        refs = judge.chain(wanted, own=True, start=start)
        ctls = (judge.chain(wanted, own=False, start=start) if judge.control
                else itertools.repeat((None, none)))
        worst = {}
        for (u, r), (_, c) in zip(refs, ctls):
            k = u - s.first
            held = Sample(tick=s.tick, update=u, foam_in=None, maps=s.frames[k],
                          foam_out=s.foam_out if k == frames - 1 else None)
            for name, v in judge.numbers(held, r, c).items():
                v = v if math.isfinite(v) else math.inf
                worst[name] = max(worst.get(name, 0.0), v)
        out.append((s.tick, worst))
    return out
