"""The strip step's kernel pair (K4, `csrc/strip_step.cu` on the pass bodies
of `csrc/step_passes.cuh`) run in NumPy on the CPU, through its global
layouts, from `ops/fft_plan.py`'s strip plans.

The kernels split every N = 2048, 4096, 8192: S blocks share each row (row
pass) and each column (column pass), S = 2, 2, 4, block e summing the
line's S parts by quarter turns while it loads (`split_term`), multiplying
by w_N^(e j) from the N-point table and transforming M = N / S points
(`fft_plan.strip_length`: 1024, 2048, 2048) into the outputs S k + e. The
model is the fused step's (`tests/test_torch_fused_plan.py`) with that
pre-stage; step plans of a shorter transform length force S = 2 and 4 at
small N, where the whole pair runs in float64 with exact tables and must equal
the plain `strip_cascade_step_reference` to 1e-10 (float64 rounding). At
the kernels' own sizes the first blocks of each pass give the bank and
sector figures and are held against `numpy.fft`.
"""
import numpy as np
import pytest
import torch

from godotoceanwaves_tpu_torch.ops import fft_plan, strip_step
from test_torch_fft_plan import REGISTERS, SM_REGISTERS, SM_SMEM, exact_table, run_block, \
    wavefronts
from test_torch_fused_plan import (L, Trace, close, col_pass, inputs, model_addresses,
                                   model_frames, row_pass, whole_sectors)

STRIP_SIZES = list(fft_plan.STRIP_SIZES)    # every N the strip kernels take


def plans(n):
    return {"rows": fft_plan.strip_rows_plan(n), "cols": fft_plan.strip_cols_plan(n)}


def split_plans(n, length):
    """The strip plans' form at a transform length the kernels do not take,
    which forces the split S = n / length at small N."""
    return {pass_: fft_plan._step_plan(length, fft_plan.STEP_THREADS, pass_ == "cols",
                                       split=n // length)
            for pass_ in ("rows", "cols")}


@pytest.mark.parametrize("n", STRIP_SIZES)
def test_strip_plans_fit_the_card(n):
    """Both plans: 4 layers of one line a block (256 threads at 2048, 512
    above), split 2 at 2048 and 4096 and 4 at 8192; within 227 KB, two
    blocks an SM within its registers (64 a thread) and shared memory; the
    pitch holds the padded extent and the join buffer a whole sequence."""
    for plan in plans(n).values():
        assert plan.n == fft_plan.strip_length(n) == (1024 if n == 2048 else 2048)
        assert plan.split == n // plan.n == {2048: 2, 4096: 2, 8192: 4}[n]
        assert plan.layers == L and plan.lines == 1 and plan.seqs == L
        assert plan.threads == L * plan.n // fft_plan.POINTS
        assert plan.smem_bytes <= fft_plan.SMEM_LIMIT and 2 * plan.smem_bytes <= SM_SMEM
        assert 2 * plan.threads * REGISTERS <= SM_REGISTERS
        assert plan.pitch >= fft_plan.extent(plan.n) and plan.join_pitch >= plan.n
    assert plans(n)["cols"].column_major and not plans(n)["rows"].column_major


@pytest.mark.parametrize("n", STRIP_SIZES)
def test_strip_exchanges_and_join_spread_over_the_banks(n):
    """The first two blocks of each pass: every exchange and join access
    takes one word a bank."""
    for plan in plans(n).values():
        exchanges = []
        run_block(plan, np.ones((plan.seqs, plan.n), complex), exact_table(plan.n), exchanges)
        assert max(wavefronts(a) for a in exchanges) == 1
    trace = Trace()
    model_addresses(plans(n), trace)
    assert max(wavefronts(a) for a in trace.join) == 1


@pytest.mark.parametrize("n", STRIP_SIZES)
def test_strip_scratch_moves_whole_sectors(n):
    """The first two blocks of each pass: the row pass's record stores (16
    bytes a lane) and the column pass's record loads (8 bytes a lane, each
    of the split's parts in its own load) cover whole 32-byte sectors."""
    trace = Trace()
    model_addresses(plans(n), trace)
    assert whole_sectors(trace.scratch_stores, 4) and whole_sectors(trace.scratch_loads, 4)


def sector_share(accesses, size):
    """The least share of the bytes of its touched 32-byte sectors that a
    warp access (elements of `size` bytes, in thread order) writes."""
    per, least = 32 // size, 1.0
    for access in accesses:
        for warp in np.array_split(access, max(1, len(access) // 32)):
            elems = np.unique(warp)
            least = min(least, len(elems) / (len(np.unique(elems // per)) * per))
    return least


@pytest.mark.parametrize("size", [2, 4])
def test_split_map_stores_write_a_share_of_their_sectors(size):
    """Block e stores map columns S k + e, every S-th element of an output
    row: each warp's map stores (2- or 4-byte elements) write 1 / S of the
    bytes of the sectors they touch, which the card merges in L2."""
    for n in STRIP_SIZES:
        trace = Trace()
        model_addresses(plans(n), trace)
        assert sector_share(trace.map_stores, size) == 1 / plans(n)["cols"].split


@pytest.mark.parametrize("n,length", [(64, 32), (64, 16), (128, 64), (128, 32), (256, 128),
                                      (256, 64)])
def test_split_pair_equals_the_plain_step(n, length):
    """The split forced through plans of a short transform length (S = 2
    and 4): one frame of 2 cascades through every block of both passes
    equals the plain version (float64 inputs and maps) to 1e-10 relative,
    and each foam texel is read and written by one thread."""
    pair = split_plans(n, length)
    assert pair["rows"].split == n // length
    args = inputs(n)
    trace = Trace()
    (out,), foam = model_frames(pair["rows"], pair["cols"], *args, trace=trace)
    want = strip_step.strip_cascade_step_reference(*(torch.from_numpy(a) for a in args),
                                                   map_dtype=torch.float64)
    for got, ref in zip((*out, foam), want):
        assert close(got, ref.numpy())
    texels = np.concatenate(trace.foam)
    assert len(np.unique(texels)) == len(texels) == 2 * n * n


@pytest.mark.parametrize("n", STRIP_SIZES)
def test_first_row_blocks_equal_numpy_fft(n):
    """The row pass's first blocks (row 0, every parity) on random layers:
    the records of row 0 hold N ifft of each layer along x."""
    rng = np.random.default_rng(n)
    lay = rng.standard_normal((L, 1, n)) + 1j * rng.standard_normal((L, 1, n))
    rows = plans(n)["rows"]
    scratch = row_pass(rows, lambda c, y0, count: lay[:, y0:y0 + count], 1,
                       exact_table(rows.n), Trace(), blocks=rows.split)
    want = np.fft.ifft(lay[:, 0], axis=-1) * n
    assert close(scratch[0, 0].T, want)


@pytest.mark.parametrize("n", STRIP_SIZES)
def test_first_column_blocks_equal_numpy_fft(n):
    """The column pass's first blocks (column 0, every parity) on random
    records: output row 0 holds N ifft of each layer along y, sign folded,
    in the displacement and the x slope."""
    rng = np.random.default_rng(n + 1)
    col = rng.standard_normal((1, n, 1, L)) + 1j * rng.standard_normal((1, n, 1, L))
    cols = plans(n)["cols"]
    foam_in = np.broadcast_to(np.zeros(1), (1, n, n))
    disp, normal, _ = col_pass(cols, col, foam_in, inputs(16, cascades=1)[4],
                               exact_table(cols.n), Trace(), blocks=cols.split)
    fields = np.fft.ifft(col[0, :, 0], axis=0).T * n * (1 - 2 * (np.arange(n) % 2))
    assert close(disp[0, :, 0], np.stack([fields[0].real, fields[0].imag, fields[1].real]))
    assert close(normal[0, 2, 0], fields[2].imag)


def test_strip_plans_refuse_sizes_outside_the_kernel():
    for n in (1024, 3000, 16384):
        with pytest.raises(ValueError):
            fft_plan.strip_rows_plan(n)
        with pytest.raises(ValueError):
            fft_plan.strip_cols_plan(n)
    with pytest.raises(ValueError):
        fft_plan.strip_length(1024)
