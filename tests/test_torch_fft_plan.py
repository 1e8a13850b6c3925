"""What the Stockham FFT kernels (`csrc/stockham.cuh`: K3's rows DFT and
K2's planes IFFT) are given, checked on the CPU: the twiddle table, the
launch plans of `ops/fft_plan.py`, and a NumPy run of the kernels' stages.

The model below runs each thread of a block as the kernels do: thread t of a
sequence holds elements t + m N/16, stage s takes the radix-Rs DFT of its
butterflies t + u N/16 after multiplying by the table's powers, and every
exchange writes and reads the shared-memory word addresses the kernel
computes (`pad`, the plan's pitch and thread mapping). It runs in float64
with an exact table, so it must equal `numpy.fft` to 1e-10 (float64
rounding); a wrong address would collide or read a stale word. The same
addresses give the bank conflicts of each warp access. The K2 pair is also
run through its global layouts (the row pass's 32-byte column records, the
column pass's output rows) at small N.
"""
import math

import numpy as np
import pytest
import torch

from godotoceanwaves_tpu_torch.ops import fft_plan

SIZES = [1 << b for b in range(4, 14)]          # every N the kernels take
BANKS = 32
REGISTERS = 64      # a thread's cap: __launch_bounds__(512, 2) in the kernels
SM_REGISTERS = 65536
SM_SMEM = 233472    # shared bytes an H100 SM holds (228 KB)


def plans(n):
    return {"rows": fft_plan.rows_plan(n), "cols": fft_plan.cols_plan(n)}


def thread_map(plan, stage):
    """(sequence, t) of every thread of a block in `stage`."""
    i = np.arange(plan.threads)
    if plan.column_major and stage == 0:
        return i % plan.seqs, i // plan.seqs
    return i // plan.threads_per_seq, i % plan.threads_per_seq


def twiddle_powers(table, step, rad):
    """w^r, r < rad, as the kernel forms them: w, w^2, w^4, w^8 from the
    table at step << b, the rest as products."""
    base = [table[step << b] for b in range(int(math.log2(rad)))]
    out = [np.ones_like(base[0]) if base else np.ones_like(step, complex)]
    for r in range(1, rad):
        p = None
        for b, w in enumerate(base):
            if r >> b & 1:
                p = w if p is None else p * w
        out.append(p)
    return np.stack(out, -1)


def run_block(plan, x, table, exchanges=None):
    """The kernel on one block: x (seqs, n) complex in, X out. Appends each
    exchange's warp accesses (word addresses) to `exchanges`."""
    n, T = plan.n, plan.threads_per_seq
    rads = fft_plan.radices(n)
    seq, t = thread_map(plan, 0)
    m = np.arange(fft_plan.POINTS)
    v = x[seq[:, None], t[:, None] + m * T]
    ns = 1
    for s, rad in enumerate(rads):
        seq, t = thread_map(plan, min(s, 1))
        groups = fft_plan.POINTS // rad
        for u in range(groups):
            cols = u + np.arange(rad) * groups
            a = v[:, cols]
            if s > 0:
                k = (t + u * T) % ns
                a = a * twiddle_powers(table, k * (n // (ns * rad)), rad)
            v[:, cols] = np.fft.ifft(a, axis=1) * rad
        if s == len(rads) - 1:
            break
        base = (t // ns) * ns * rad + t % ns
        words = np.full(plan.seqs * plan.pitch, np.nan + 0j)
        stores = [seq * plan.pitch + fft_plan.pad(s, base + r * ns) for r in range(rad)]
        addr = np.stack(stores, 1)
        assert addr.max() < plan.seqs * plan.pitch
        assert len(np.unique(addr)) == addr.size, "two elements share a word"
        assert all(fft_plan.pad(s, a) < plan.pitch for a in (base + (rad - 1) * ns))
        words[addr] = v
        seq, t = thread_map(plan, s + 1)
        loads = [seq * plan.pitch + fft_plan.pad(s, t + mm * T) for mm in m]
        v = words[np.stack(loads, 1)]
        if exchanges is not None:
            exchanges.extend(stores + loads)
        ns *= rad
    out = np.full_like(x, np.nan)
    seq, t = thread_map(plan, min(len(rads) - 1, 1))
    out[seq[:, None], t[:, None] + m * T] = v
    return out


def wavefronts(addr):
    """The most words that one bank serves in one warp access."""
    worst = 1
    for warp in np.array_split(addr, max(1, len(addr) // 32)):
        words = np.unique(warp)
        worst = max(worst, int(np.bincount(words % BANKS).max()))
    return worst


def exact_table(n):
    return np.exp(2j * np.pi * np.arange(n // 2) / n)


@pytest.mark.parametrize("n", SIZES)
def test_twiddle_table_is_the_rounded_exponential(n):
    """Every entry within fp32 rounding (half an ulp of 1) of the float64
    e^{+2 pi i j / N}, and built once per (N, device)."""
    table = fft_plan.twiddles(n, "cpu")
    assert table.dtype == torch.float32 and tuple(table.shape) == (n // 2, 2)
    want = exact_table(n)
    got = table.double().numpy()
    assert np.abs(got[:, 0] - want.real).max() <= 2.0 ** -25 + 1e-15
    assert np.abs(got[:, 1] - want.imag).max() <= 2.0 ** -25 + 1e-15
    assert fft_plan.twiddles(n, torch.device("cpu")) is table


@pytest.mark.parametrize("n", SIZES)
def test_plans_fit_the_card(n):
    """Both plans of every N within a block's 512 threads and 227 KB, and two
    blocks an SM within its registers (64 a thread, under 255) and shared
    memory; the pitch holds a sequence's padded extent."""
    for plan in plans(n).values():
        assert plan.n == n and plan.seqs >= 1 and plan.threads <= fft_plan.MAX_THREADS
        assert plan.smem_bytes <= fft_plan.SMEM_LIMIT and 2 * plan.smem_bytes <= SM_SMEM
        assert 2 * plan.threads * REGISTERS <= SM_REGISTERS and REGISTERS <= 255
        assert plan.pitch >= fft_plan.extent(n)
        assert math.prod(fft_plan.radices(n)) == n
        assert all(r <= fft_plan.POINTS for r in fft_plan.radices(n))
    assert n % fft_plan.cols_plan(n).seqs == 0


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("n", SIZES)
def test_stockham_model_equals_numpy_fft(kind, n):
    plan = plans(n)[kind]
    rng = np.random.default_rng(n)
    x = rng.standard_normal((plan.seqs, n)) + 1j * rng.standard_normal((plan.seqs, n))
    got = run_block(plan, x, exact_table(n))
    want = np.fft.ifft(x, axis=1) * n
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("n", SIZES)
def test_exchanges_spread_over_the_banks(kind, n):
    """No exchange access conflicts on a bank from N = 512 up (a warp holds
    one sequence's threads, or the column pass's stage-0 mapping); below,
    where a warp spans sequences, at most two words a bank."""
    plan = plans(n)[kind]
    exchanges = []
    x = np.ones((plan.seqs, n), complex)
    run_block(plan, x, exact_table(n), exchanges)
    worst = max((wavefronts(a) for a in exchanges), default=1)
    assert worst <= (1 if n >= 512 else 2)


@pytest.mark.parametrize("n", [128, 512, 2048, 8192])
def test_row_pass_moves_whole_sectors(n):
    """The row pass's loads and stores (natural rows, and the 32-byte column
    records of K2's intermediate) touch whole 32-byte sectors in each warp."""
    plan = fft_plan.rows_plan(n)
    seq, t = thread_map(plan, 0)
    r = n           # K2's row pass: R = N rows a plane
    for m in range(fft_plan.POINTS):
        k = t + m * plan.threads_per_seq
        for words in (seq * n + k,
                      ((k // fft_plan.TILE) * r + seq) * fft_plan.TILE + k % fft_plan.TILE):
            for warp in np.array_split(words, len(words) // 32):
                sectors = np.unique(warp // 8)
                assert len(sectors) * 8 == len(np.unique(warp))


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("fold_sign", [False, True])
def test_planes_pair_through_its_global_layouts(n, fold_sign):
    """The K2 pair at the kernels' global addresses: the row pass stores each
    row's column x at record (x / 8, y, x mod 8); the column pass reads a
    block's columns from those records and writes them as output rows. The
    result is transpose(N^2 ifft2(x)) (-1)^(x+y)."""
    rows, cols, w = fft_plan.rows_plan(n), fft_plan.cols_plan(n), fft_plan.TILE
    rng = np.random.default_rng(n + fold_sign)
    x = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    table = exact_table(n)
    mid = np.full(n * n, np.nan + 0j)
    for y0 in range(0, n, rows.seqs):
        live = min(rows.seqs, n - y0)       # rows past R load zeros and are not stored
        block = np.zeros((rows.seqs, n), complex)
        block[:live] = x[y0:y0 + live]
        got = run_block(rows, block, table)[:live]
        y, k = np.meshgrid(np.arange(y0, y0 + live), np.arange(n), indexing="ij")
        mid[((k // w) * n + y) * w + k % w] = got
    assert not np.isnan(mid).any()
    out = np.full((n, n), np.nan + 0j)
    for x0 in range(0, n, cols.seqs):
        xs = np.arange(x0, x0 + cols.seqs)[:, None]
        ys = np.arange(n)[None, :]
        block = mid[(xs // w) * n * w + xs % w + ys * w]
        out[x0:x0 + cols.seqs] = run_block(cols, block, table)
    if fold_sign:
        out = out * (1 - 2 * (np.add.outer(np.arange(n), np.arange(n)) % 2))
    want = (np.fft.ifft2(x) * n * n).T
    if fold_sign:
        want = want * (1 - 2 * (np.add.outer(np.arange(n), np.arange(n)) % 2))
    assert np.abs(out - want).max() <= 1e-10 * np.abs(want).max()


def test_plans_refuse_sizes_outside_the_core():
    for n in (8, 48, 16384):
        with pytest.raises(ValueError):
            fft_plan.rows_plan(n)
        with pytest.raises(ValueError):
            fft_plan.cols_plan(n)
