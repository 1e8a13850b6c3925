"""The inputs of a run, drawn from its seed: the same for the program and the reference.

Pure Python and NumPy. A seed changes the spectra and the camera path and
nothing else: every seed runs the same sizes, the same tick length and the
same number of particles.
"""
from __future__ import annotations

import numpy as np

SEED_STREAMS = {"spectrum": 0, "camera": 1, "samples": 2}


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator for one use of the run's seed. Any whole
    number is a seed, however large or negative."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), SEED_STREAMS[stream]])


def cascade_specs(config: dict, seed: int) -> list[dict]:
    """The configuration's cascades, each with a spectrum seed pair drawn
    from `seed` in the configuration's range."""
    lo, hi = config["spectrum_seed_range"]
    draws = rng(seed, "spectrum").integers(lo, hi + 1, size=(len(config["cascades"]), 2))
    return [dict(c, spectrum_seed=[int(v) for v in d])
            for c, d in zip(config["cascades"], draws)]


def camera_path(workload: dict, seed: int):
    """`pose(tick) -> (position, pitch, yaw, fov)` for the frame driver: a
    fixed height and pitch, the yaw sweeping from a seeded start at a fixed
    rate a tick (tick counts every tick of the run, warm-up included)."""
    cam = workload["camera"]
    yaw0 = float(rng(seed, "camera").uniform(0.0, 360.0))
    pos = (0.0, float(cam["height"]), 0.0)

    def pose(tick: int):
        return pos, float(cam["pitch_deg"]), yaw0 + cam["yaw_deg_per_tick"] * tick, float(cam["fov_deg"])
    return pose


def sample_ticks(workload: dict, seed: int, limit: int = 1 << 24) -> set[int]:
    """The window ticks the judge compares: the first `replay_ticks`, and one
    tick drawn from the seed in each octave [2^j, 2^(j+1)) from
    `octave_from` on, so that a sample reaches every part of a window of
    any length."""
    judge = workload["judge"]
    gen = rng(seed, "samples")
    ticks = set(range(judge["replay_ticks"]))
    j = judge["octave_from"]
    while (1 << j) < limit:
        ticks.add(int(gen.integers(1 << j, 1 << (j + 1))))
        j += 1
    return ticks
