"""Launch plans and twiddle tables of the Stockham FFT core
(`csrc/stockham.cuh`), which the rows DFT (`rows_fft.py`, K3), the planes
IFFT (`planes_fft.py`, K2) and the fused step (`fused_step.py`, K1) run on.

A length-N sequence (a power of two, 16 <= N <= 8192) is held by N / 16
threads, 16 points a thread, and transformed by radix-16 stages, the last of
radix 2^(log2 N mod 4) where 4 does not divide log2 N, with one exchange
through shared memory between two stages. A plan chooses how many
sequences a block holds and how far apart they lie in the exchange buffer
(the pitch, in 4-byte words), so that no access of an exchange meets
another on a shared-memory bank where that can be had (every N >= 512;
two accesses a bank at most below, where a warp spans several sequences).
`tests/test_torch_fft_plan.py` runs the kernel's stages in NumPy from these
plans, with the addresses the kernel computes, and holds them to that.

The fused step's plans (`step_rows_plan`, `step_cols_plan`) hold 4 layer
sequences for each row or column of a block, and a join buffer
(`join_pitch`) in the exchange buffer's place: through it the row pass
hands each modulated texel's 4 layers to their sequences, and the column
pass brings the 4 layers of each output texel together. The strip step's
plans (`strip_rows_plan`, `strip_cols_plan`) are the same with a split: the
transform is `strip_length(N)` points (1024 at N = 2048, 2048 above), and
N / length blocks share each row or column of an N x N map, block e taking
the outputs of parity e mod split after a radix-split pre-stage
(`csrc/step_passes.cuh`).

The kernels take the plan as arguments and refuse one that does not fit
them. Nothing here touches the card except `twiddles`, which builds the
table on the tensor's device.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

POINTS = 16            # points a thread holds (stockham::kPoints)
MIN_N, MAX_N = 16, 8192
MAX_THREADS = 512      # a block (stockham::kMaxThreads)
SMEM_LIMIT = 232448    # dynamic shared bytes a block can have on the H100 (227 KB)
TILE = 8               # columns a record of the planes IFFT's intermediate holds (32 bytes)
ROWS_THREADS = 128     # threads a row-pass block aims at
COLS_THREADS = 256     # threads a column-pass block aims at
LAYERS = 4             # packed layers of the fused step (texel::kLayers)
STEP_MAX_N = 1024      # the fused step's largest N
STEP_THREADS = 256     # threads a fused-step block aims at, either pass
STRIP_SIZES = (2048, 4096, 8192)   # the strip step's N


def log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"N must be a power of two, got {n}")
    return n.bit_length() - 1


def radices(n: int) -> tuple[int, ...]:
    """The radix of each stage: 16 until the last, which takes what is left."""
    bits, out = log2(n), []
    while bits > 0:
        out.append(1 << min(4, bits))
        bits -= min(4, bits)
    return tuple(out)


def pad(stage: int, a: int) -> int:
    """Padded word index of element `a` in the exchange after `stage`
    (stockham::pad): a word every 32 after stage 0, 16 every 256 after
    stage 1, none later."""
    if stage == 0:
        return a + (a >> 5)
    if stage == 1:
        return a + ((a >> 8) << 4)
    return a


def extent(n: int) -> int:
    """Words a sequence spans in the exchange buffer (0: one stage, no
    exchange) (stockham::extent)."""
    stages = len(radices(n))
    return 0 if stages < 2 else pad(min(stages - 2, 1), n - 1) + 1


@dataclasses.dataclass(frozen=True)
class Plan:
    n: int
    seqs: int      # sequences a block: layers x lines (rows or columns)
    pitch: int     # words between two sequences in the exchange buffer
    column_major: bool = False   # stage 0 maps consecutive threads to consecutive sequences
    layers: int = 1     # sequences of one line; sequence s is layer s mod layers of line s / layers
    join_pitch: int = 0   # words between two sequences in the join buffer (0: no join)
    split: int = 1      # blocks a line of n * split points; block e takes the outputs e mod split

    @property
    def lines(self) -> int:
        """Rows or columns a block."""
        return self.seqs // self.layers

    @property
    def threads_per_seq(self) -> int:
        return self.n // POINTS

    @property
    def threads(self) -> int:
        return self.seqs * self.threads_per_seq

    @property
    def smem_bytes(self) -> int:
        """Re and Im words of every sequence of a block, in the exchange
        buffer or in the join buffer, which reuses it."""
        return 2 * 4 * self.seqs * max(self.pitch, self.join_pitch)


def _pitch(n: int, seqs: int, column_major: bool) -> int:
    """The extent plus the padding that spreads a warp's sequences over the
    banks: the column pass's stage 0 puts `seqs` sequences side by side in a
    warp, so their rows of words start 16 / seqs banks apart; below 32
    threads a sequence, two words apart."""
    e = extent(n)
    if e == 0:
        return 0
    if n // POINTS < 32:
        return e + 2
    return e + (16 // seqs if column_major and seqs <= 16 else 0)


def _check(n: int) -> None:
    if not (MIN_N <= n <= MAX_N) or n & (n - 1):
        raise ValueError(f"the Stockham core takes power-of-two N in [{MIN_N}, {MAX_N}], got {n}")


@functools.lru_cache(maxsize=None)
def rows_plan(n: int) -> Plan:
    """Rows a block: ROWS_THREADS / (N / 16), at least one."""
    _check(n)
    seqs = max(1, ROWS_THREADS // (n // POINTS))
    return Plan(n, seqs, _pitch(n, seqs, False))


@functools.lru_cache(maxsize=None)
def cols_plan(n: int) -> Plan:
    """Columns a block: COLS_THREADS / (N / 16), at least one, at most N."""
    _check(n)
    seqs = min(n, max(1, COLS_THREADS // (n // POINTS)))
    return Plan(n, seqs, _pitch(n, seqs, True), column_major=True)


def _check_step(n: int) -> None:
    if not (MIN_N <= n <= STEP_MAX_N) or n & (n - 1):
        raise ValueError(f"the fused step takes power-of-two N in [{MIN_N}, {STEP_MAX_N}], "
                         f"got {n}")


def _join_pitch(n: int) -> int:
    """Words between two sequences in the fused step's join buffer, which
    holds a sequence's N points: N + N / 16 below 32 threads a sequence (a
    warp's sequences start on different banks), else N + 8, so that the
    row pass's lanes that gather layers 0-1 and 2-3 of 16 texels fall 16
    banks apart."""
    t = n // POINTS
    return n + (t if t < 32 else 8)


def _step_plan(n: int, threads: int, column_major: bool, split: int = 1) -> Plan:
    lines = min(n, max(1, threads // (LAYERS * (n // POINTS))))
    seqs = LAYERS * lines
    return Plan(n, seqs, _pitch(n, seqs, column_major), column_major, LAYERS, _join_pitch(n),
                split)


@functools.lru_cache(maxsize=None)
def step_rows_plan(n: int) -> Plan:
    """The fused row pass: rows a block, each as 4 layer sequences,
    STEP_THREADS / (4 N / 16) rows, at least one, at most N. The join buffer
    carries the modulated layers to the threads of their sequences and the
    transformed ones back to the texel records."""
    _check_step(n)
    return _step_plan(n, STEP_THREADS, False)


@functools.lru_cache(maxsize=None)
def step_cols_plan(n: int) -> Plan:
    """The fused column pass: columns a block, each as 4 layer sequences,
    STEP_THREADS / (4 N / 16) columns, at least one, at most N. The join buffer
    brings the 4 layers of each output texel together for the unpack."""
    _check_step(n)
    return _step_plan(n, STEP_THREADS, True)


def strip_length(n: int) -> int:
    """The strip step's transform length at N: 1024 at 2048 (split 2, 4 x 64
    threads a block), 2048 above (split 2 and 4, 4 x 128 threads: a 4096-point
    sequence would not fit a block). At 2048 the split's 256-thread blocks
    measured faster than one 512-thread block a line, though each texel is
    then modulated twice and each record read twice."""
    if n not in STRIP_SIZES:
        raise ValueError(f"the strip step takes N in {STRIP_SIZES}, got {n}")
    return 1024 if n == 2048 else 2048


@functools.lru_cache(maxsize=None)
def strip_rows_plan(n: int) -> Plan:
    """The strip row pass of an N x N map: one row a block as 4 layer
    sequences of `strip_length(N)` points, N / length blocks a row (the
    split)."""
    length = strip_length(n)
    return _step_plan(length, STEP_THREADS, False, split=n // length)


@functools.lru_cache(maxsize=None)
def strip_cols_plan(n: int) -> Plan:
    """The strip column pass of an N x N map: one column a block as 4 layer
    sequences of `strip_length(N)` points, N / length blocks a column."""
    length = strip_length(n)
    return _step_plan(length, STEP_THREADS, True, split=n // length)


_TWIDDLES: dict[tuple[int, str], torch.Tensor] = {}


def twiddles(n: int, device) -> torch.Tensor:
    """(N / 2, 2) fp32 table of e^{+2 pi i j / N}, j < N / 2: computed in
    float64 on `device`, rounded once, kept per (N, device)."""
    device = torch.device(device)
    key = (n, str(device))
    table = _TWIDDLES.get(key)
    if table is None:
        angle = torch.arange(n // 2, dtype=torch.float64, device=device) * (2.0 * math.pi / n)
        table = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1).to(torch.float32)
        _TWIDDLES[key] = table
    return table
