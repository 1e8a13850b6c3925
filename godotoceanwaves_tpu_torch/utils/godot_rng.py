"""Godot's RandomNumberGenerator (PCG-XSH-RR 32), bit-exact.

The reference seeds each cascade's spectrum from a host RNG fixed at 1234
("This seed gives big waves!", water.gd:68-69) and draws
`randi_range(-10000, 10000)` pairs (water.gd:31). Godot's generator is the
canonical pcg32 it vendors in thirdparty/misc/pcg.{h,cpp}, wrapped by
core/math/random_pcg.{h,cpp}:

- `set_seed(s)` runs `pcg32_srandom_r(&pcg, s, inc)`: state=0,
  inc=(initseq<<1)|1, advance, state+=s, advance — NOT `state := seed`.
  The initseq Godot passes is its PCG_DEFAULT_INC (1442695040888963407).
- `randi()` is `pcg32_random_r`: 64-bit LCG advance + XSH-RR output.
- `randi_range(from, to)` is RandomPCG::random(int, int): equal endpoints
  short-circuit, bounds = |from-to|+1, then `pcg32_boundedrand_r` (rejection
  sampling below the modulo threshold — unbiased, may consume >1 draw),
  offset by min(from, to).

The pcg32 core is validated against the canonical pcg-c-basic check vectors
(srandom(42, 54) round 1) in tests/test_rng.py, so seed semantics and the
output permutation are pinned bit-exactly; the Godot-specific wiring above is
transcribed from the Godot 4.x sources cited per method and cross-validated
against an independent C transcription (tests/godot_rng_twin.c) that pins
the seed-1234 randi_range stream with literal values.
"""
from __future__ import annotations

_MULT = 6364136223846793005
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1

# thirdparty/misc/pcg.h: PCG_DEFAULT_INC, passed as initseq by RandomPCG
PCG_DEFAULT_INC = 1442695040888963407


class Pcg32:
    """Canonical pcg32 (pcg-c-basic): srandom_r seed protocol + XSH-RR."""

    def __init__(self, initstate: int, initseq: int = PCG_DEFAULT_INC):
        self.state = 0
        self.inc = 0
        self.srandom(initstate, initseq)

    def srandom(self, initstate: int, initseq: int) -> None:
        # pcg32_srandom_r (pcg.cpp): state=0; inc=(initseq<<1)|1; advance;
        # state += initstate; advance.
        self.state = 0
        self.inc = ((initseq << 1) | 1) & _MASK64
        self.random()
        self.state = (self.state + initstate) & _MASK64
        self.random()

    def random(self) -> int:
        old = self.state
        self.state = (old * _MULT + self.inc) & _MASK64
        xorshifted = (((old >> 18) ^ old) >> 27) & _MASK32
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) & _MASK32

    def boundedrand(self, bound: int) -> int:
        # pcg32_boundedrand_r: rejection below threshold = (2^32 - bound) % bound
        threshold = ((1 << 32) - bound) % bound
        while True:
            r = self.random()
            if r >= threshold:
                return r % bound


class GodotRNG:
    """RandomNumberGenerator semantics on top of the pcg32 core."""

    def __init__(self, seed: int = 0):
        self._pcg = Pcg32(seed & _MASK64)

    def set_seed(self, seed: int) -> None:
        # RandomPCG::seed: pcg32_srandom_r(&pcg, p_seed, current_inc)
        self._pcg.srandom(seed & _MASK64, PCG_DEFAULT_INC)

    def randi(self) -> int:
        return self._pcg.random()

    def randi_range(self, lo: int, hi: int) -> int:
        # RandomPCG::random(int, int) (core/math/random_pcg.cpp)
        if lo == hi:
            return lo
        bounds = abs(lo - hi) + 1
        return min(lo, hi) + self._pcg.boundedrand(bounds)
