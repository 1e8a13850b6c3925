"""The fused step's kernel pair (K1, `csrc/fused_step.cu`) run in NumPy on
the CPU, through its global layouts, from `ops/fft_plan.py`'s step plans.

The row pass: thread i of a block modulates texels i + j B (B threads a
block, j < 4) of its R rows and writes layer l of texel (r, x) to word x of
sequence s = 4 r + l of the join buffer; after a barrier thread t of
sequence s loads its points t + m N/16 from there. The Stockham stages run
as `run_block` runs them (the kernels' exchange addresses, an exact table).
Then the outputs go back to the join buffer, and each thread gathers 16
bytes of a texel record (layers 2h and 2h + 1) a store into the scratch of
32-byte texel records (C, N, N, 8). The column pass: stage 0 loads with
the sequence (column x, layer l) fastest across the warp from those
records; after the transform thread (s, t) writes its 16 outputs to the join
buffer at s * join_pitch + t + m N/16, and then unpacks the outputs
m = t + (l + 4 j) N/16, j < 4, reading the 4 layers of each from the join
buffer. In float64 with an exact table the result must equal the port's
plain `fused_cascade_step_reference` to 1e-10 (float64 rounding); a wrong
address would collide, read a NaN, or land a layer on the wrong texel.
The same addresses give the bank conflicts of the join and the sectors of
the global stores.
"""
import numpy as np
import pytest
import torch

from godotoceanwaves_tpu_torch.ops import fft_plan, fused_step
from test_torch_fft_plan import (REGISTERS, SM_REGISTERS, SM_SMEM, exact_table, run_block,
                                 thread_map, wavefronts)

STEP_SIZES = [1 << b for b in range(4, 11)]     # every N the fused kernels take
L = fft_plan.LAYERS
TWO_PI = float(np.float32(2.0 * np.pi))          # the fp32 2 pi both versions divide


def plans(n):
    return {"rows": fft_plan.step_rows_plan(n), "cols": fft_plan.step_cols_plan(n)}


def inputs(n, cascades=2, seed=0):
    """float64 h0, h0nc (C, 2, N, N), omega, foam (C, N, N) and scalar rows."""
    rng = np.random.default_rng(seed + n)
    h0 = rng.standard_normal((cascades, 2, n, n)) * 0.1
    h0nc = rng.standard_normal((cascades, 2, n, n)) * 0.1
    omega = rng.uniform(0.5, 20.0, (cascades, n, n))
    foam = rng.uniform(0.0, 0.5, (cascades, n, n))
    scal = np.zeros((cascades, 1, fused_step.NUM_SCALARS))
    scal[:, 0, fused_step.S_TIME] = rng.uniform(100.0, 130.0, cascades)
    scal[:, 0, fused_step.S_LX] = rng.uniform(20.0, 300.0, cascades)
    scal[:, 0, fused_step.S_LY] = rng.uniform(20.0, 300.0, cascades)
    scal[:, 0, fused_step.S_WHITECAP] = rng.uniform(-0.5, 0.9, cascades)
    scal[:, 0, fused_step.S_GROW] = rng.uniform(0.1, 0.7, cascades)
    scal[:, 0, fused_step.S_DECAY] = rng.uniform(0.05, 0.5, cascades)
    scal[:, 0, fused_step.S_DT] = 0.02
    return h0, h0nc, omega, foam, scal


def modulate(h0, h0nc, omega, sc, frame, n):
    """texel::modulate of every texel of one cascade: (4, N, N) complex."""
    t = sc[fused_step.S_TIME] + sc[fused_step.S_DT] * frame
    kx = (np.arange(n) - 0.5 * n)[None, :] * (TWO_PI / sc[fused_step.S_LX])
    ky = (np.arange(n) - 0.5 * n)[:, None] * (TWO_PI / sc[fused_step.S_LY])
    kx, ky = np.broadcast_arrays(kx, ky)
    k = np.sqrt(kx * kx + ky * ky) + 1e-6
    s, co = np.sin(omega * t), np.cos(omega * t)
    (ar, ai), (br, bi) = h0, h0nc
    hr = co * (ar + br) + s * (bi - ai)
    hi = s * (ar - br) + co * (ai + bi)
    kux, kuy = kx / k, ky / k
    a0, a2 = 1.0 + kuy, kx - ky * kuy
    return np.stack([-hi * a0 + 1j * hr * a0,
                     (-hi * kux - hr * ky) + 1j * (hr * kux - hi * ky),
                     -hi * a2 + 1j * hr * a2,
                     kux * (hi * ky - hr * kx) - 1j * kux * (hr * ky + hi * kx)])


def unpack(lay, kx, m, foam_prev, sc):
    """texel::unpack of output texels (kx, m): (displacement (3, ...),
    normal (4, ...), foam)."""
    sign = 1.0 - 2.0 * ((kx + m) % 2)
    hx, hy = lay[0].real * sign, lay[0].imag * sign
    hz, dhy_dx = lay[1].real * sign, lay[1].imag * sign
    dhy_dz, dhx_dx = lay[2].real * sign, lay[2].imag * sign
    dhz_dz, dhz_dx = lay[3].real * sign, lay[3].imag * sign
    jac = (1.0 + dhx_dx) * (1.0 + dhz_dz) - dhz_dx * dhz_dx
    factor = -np.minimum(0.0, jac - sc[fused_step.S_WHITECAP])
    foam = foam_prev * np.exp(-sc[fused_step.S_DECAY]) + factor * sc[fused_step.S_GROW]
    foam = np.clip(foam, 0.0, 1.0)
    normal = np.stack([dhy_dx / (1.0 + np.abs(dhx_dx)), dhy_dz / (1.0 + np.abs(dhz_dz)),
                       dhx_dx, foam])
    return np.stack([hx, hy, hz]), normal, foam


class Trace:
    """What the model saw: each warp access of the join buffers (both
    passes), as word addresses in thread order; each global access of the
    scratch and the maps, as (threads, words) element addresses in thread
    order; and the foam texel that each thread reads and then writes
    (foam_in may alias foam_out)."""

    def __init__(self):
        self.join, self.scratch_stores, self.scratch_loads = [], [], []
        self.map_stores, self.foam = [], []


def row_pass(n, h0, h0nc, omega, scal, frame, table, trace, blocks=None):
    """The row pass of every cascade: the scratch as a flat complex array,
    layer l of texel (c, y, k) at 4 ((c N + y) N + k) + l (the fp32 record
    (C, N, N, 8) holds its Re and Im at twice that and one more). `blocks`
    runs only the first blocks of each cascade."""
    plan = plans(n)["rows"]
    lines, tps, jp = plan.lines, plan.threads_per_seq, plan.join_pitch
    scratch = np.full(h0.shape[0] * n * n * L, np.nan + 0j)
    seq, t = thread_map(plan, 1)
    i = np.arange(plan.threads)
    for c in range(h0.shape[0]):
        lay = modulate(h0[c], h0nc[c], omega[c], scal[c, 0], frame, n)
        for y0 in range(0, n, lines)[:blocks]:
            # thread i modulates texels i + j B of the block's rows once and
            # writes layer l of texel (r, x) to sequence 4 r + l of the join
            # buffer
            words = np.full(plan.seqs * jp, np.nan + 0j)
            for j in range(fft_plan.POINTS // L):
                r, x = (i + j * plan.threads) // n, (i + j * plan.threads) % n
                for q in range(L):
                    addr = (r * L + q) * jp + x
                    assert np.isnan(words[addr]).all(), "two layers share a join word"
                    words[addr] = lay[q, y0 + r, x]
                    trace.join.append(addr)
            # thread (s, t) loads its points t + m T of sequence s
            block = np.empty((plan.seqs, n), complex)
            for m in range(fft_plan.POINTS):
                addr = seq * jp + t + m * tps
                block[seq, t + m * tps] = words[addr]
                trace.join.append(addr)
            assert not np.isnan(block).any(), "a sequence loaded a word never written"
            out = run_block(plan, block, table)
            # the join: thread (s, t) writes its outputs t + m T back ...
            words = np.full(plan.seqs * jp, np.nan + 0j)
            for m in range(fft_plan.POINTS):
                addr = seq * jp + t + m * tps
                words[addr] = out[seq, t + m * tps]
                trace.join.append(addr)
            # ... and stores 16 bytes of a record a slot: slot i + u B holds
            # layers 2h and 2h + 1 of the block's texel slot / 2, h = slot mod 2
            first = (c * n + y0) * n
            for u in range(2 * fft_plan.POINTS // L):
                slot = i + u * plan.threads
                q, h = slot // 2, slot % 2
                w0 = ((q // n) * L + 2 * h) * jp + q % n
                trace.join.extend([w0, w0 + jp])
                for e, w in enumerate((w0, w0 + jp)):
                    a = (first + q) * L + 2 * h + e
                    assert np.isnan(scratch[a]).all(), "two stores share a scratch word"
                    scratch[a] = words[w]
                    assert not np.isnan(scratch[a]).any(), "a record got a word never written"
                trace.scratch_stores.append(4 * (2 * first + slot)[:, None] + np.arange(4))
    assert blocks or not np.isnan(scratch).any(), "a scratch word was never stored"
    return scratch


def col_pass(n, scratch, foam_in, scal, table, trace, blocks=None):
    """The column pass of every cascade: (displacement, normal, foam).
    `blocks` runs only the first blocks of each cascade."""
    plan = plans(n)["cols"]
    lines, tps, jp, seqs = plan.lines, plan.threads_per_seq, plan.join_pitch, plan.seqs
    cascades = foam_in.shape[0]
    disp = np.full((cascades, 3, n, n), np.nan)
    normal = np.full((cascades, 4, n, n), np.nan)
    foam = np.full((cascades, n, n), np.nan)
    s0, t0 = thread_map(plan, 0)
    s1, t1 = thread_map(plan, 1)
    for c in range(cascades):
        for x0 in range(0, n, lines)[:blocks]:
            # stage 0: sequence (column x0 + s / 4, layer s mod 4) fastest
            layer, x = s0 % L, x0 + s0 // L
            block = np.empty((seqs, n), complex)
            for m in range(fft_plan.POINTS):
                y = t0 + m * tps
                rec = (c * n + y) * n + x
                block[s0, y] = scratch[rec * L + layer]
                trace.scratch_loads.append((8 * rec + 2 * layer)[:, None] + np.arange(2))
            out = run_block(plan, block, table)
            # the join: thread (s, t) writes its outputs t + m T
            words = np.full(seqs * jp, np.nan + 0j)
            for m in range(fft_plan.POINTS):
                addr = s1 * jp + t1 + m * tps
                assert np.isnan(words[addr]).all(), "two outputs share a join word"
                words[addr] = out[s1, t1 + m * tps]
                trace.join.append(addr)
            # ... and unpacks outputs t + (layer + 4 j) T of its column
            layer, col = s1 % L, s1 // L
            kx = x0 + col
            for j in range(fft_plan.POINTS // L):
                m = t1 + (layer + L * j) * tps
                reads = [(col * L + q) * jp + m for q in range(L)]
                trace.join.extend(reads)
                lay = np.stack([words[a] for a in reads])
                assert not np.isnan(lay).any(), "the join read a word never written"
                d, nm, f = unpack(lay, kx, m, foam_in[c, kx, m], scal[c, 0])
                assert np.isnan(foam[c, kx, m]).all(), "two threads unpack one texel"
                disp[c][:, kx, m], normal[c][:, kx, m], foam[c, kx, m] = d, nm, f
                trace.map_stores.append((kx * n + m)[:, None])
                trace.foam.append((c * n + kx) * n + m)
    assert blocks or not np.isnan(foam).any(), "a texel was never unpacked"
    return disp, normal, foam


def model_frames(n, h0, h0nc, omega, foam, scal, frames=1, trace=None):
    """`frames` frames of the pair, foam carried from one to the next."""
    trace = Trace() if trace is None else trace
    table = exact_table(n)
    out = []
    for k in range(frames):
        scratch = row_pass(n, h0, h0nc, omega, scal, k, table, trace)
        d, nm, foam = col_pass(n, scratch, foam, scal, table, trace)
        out.append((d, nm))
    return out, foam


def close(got, want):
    return np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_pair_through_its_global_layouts_equals_the_plain_step(n):
    """One frame of 2 cascades: the model equals the plain version (float64
    inputs, float64 maps) to 1e-10 relative."""
    args = inputs(n)
    (out,), foam = model_frames(n, *args)
    want = fused_step.fused_cascade_step_reference(*(torch.from_numpy(a) for a in args),
                                                   map_dtype=torch.float64)
    for got, ref in zip((*out, foam), want):
        assert close(got, ref.numpy())


def test_pair_carries_foam_in_place_across_frames():
    """Three frames, foam read and written in place: a frame's threads each
    read and then write their own foam texels, no texel twice, and the
    frames equal the plain multi-frame version to 1e-10 relative."""
    n, frames = 64, 3
    args = inputs(n, seed=5)
    trace = Trace()
    out, foam = model_frames(n, *args, frames=frames, trace=trace)
    want = fused_step.fused_cascade_multi_step_reference(
        *(torch.from_numpy(a) for a in args), num_frames=frames, map_dtype=torch.float64)
    for k in range(frames):
        assert close(out[k][0], want[0][:, k].numpy()) and close(out[k][1], want[1][:, k].numpy())
    assert close(foam, want[2].numpy())
    per_frame = np.split(np.concatenate(trace.foam), frames)
    for texels in per_frame:
        assert len(np.unique(texels)) == len(texels) == 2 * n * n


@pytest.mark.parametrize("n", STEP_SIZES)
def test_step_plans_fit_the_card(n):
    """Both plans within a block's 512 threads and 227 KB, two blocks an SM
    within its registers (64 a thread) and shared memory; the pitch holds
    the padded extent, the join buffer a whole sequence, and the lines
    divide N."""
    for plan in plans(n).values():
        assert plan.n == n and plan.layers == L and plan.seqs == L * plan.lines
        assert plan.threads <= fft_plan.MAX_THREADS and n % plan.lines == 0
        assert plan.smem_bytes <= fft_plan.SMEM_LIMIT and 2 * plan.smem_bytes <= SM_SMEM
        assert 2 * plan.threads * REGISTERS <= SM_REGISTERS
        assert plan.pitch >= fft_plan.extent(n)
        assert plan.join_pitch >= n
    assert plans(n)["cols"].column_major and not plans(n)["rows"].column_major


@pytest.mark.parametrize("n", STEP_SIZES)
def test_step_exchanges_and_join_spread_over_the_banks(n):
    """No exchange or join access (both passes) conflicts on a bank from
    N = 512 up; below, where a warp spans sequences, at most two words a
    bank (8 column-pass sequences at N = 1024 included)."""
    limit = 1 if n >= 512 else 2
    for plan in plans(n).values():
        exchanges = []
        run_block(plan, np.ones((plan.seqs, n), complex), exact_table(n), exchanges)
        assert max((wavefronts(a) for a in exchanges), default=1) <= limit
    trace = Trace()
    h0, h0nc, omega, foam, scal = inputs(n, cascades=1)
    row_pass(n, h0, h0nc, omega, scal, 0, exact_table(n), trace, blocks=2)
    col_pass(n, np.zeros(L * n * n, complex), foam, scal, exact_table(n), trace, blocks=2)
    assert max(wavefronts(a) for a in trace.join) <= limit


def whole_sectors(accesses, size):
    """Whether each warp access ((threads, elements) addresses of `size`
    bytes, in thread order) covers only whole 32-byte sectors."""
    per = 32 // size
    for access in accesses:
        for warp in np.array_split(access, max(1, len(access) // 32)):
            elems = np.unique(warp)
            if len(np.unique(elems // per)) * per != len(elems):
                return False
    return True


@pytest.mark.parametrize("n", STEP_SIZES)
def test_scratch_moves_whole_sectors(n):
    """The row pass's record stores (16 bytes a lane) and the column pass's
    record loads (8 bytes a lane, the 4 layers of a column in adjacent
    lanes) cover whole 32-byte sectors in each warp."""
    trace = Trace()
    h0, h0nc, omega, foam, scal = inputs(n, cascades=1)
    scratch = row_pass(n, h0, h0nc, omega, scal, 0, exact_table(n), trace, blocks=2)
    col_pass(n, np.nan_to_num(scratch), foam, scal, exact_table(n), trace, blocks=2)
    assert whole_sectors(trace.scratch_stores, 4) and whole_sectors(trace.scratch_loads, 4)


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("size", [2, 4])
def test_column_pass_map_stores_whole_sectors(n, size):
    """Each warp's map stores (bf16/f16 or fp32 elements of an output row)
    cover whole 32-byte sectors."""
    trace = Trace()
    col_pass(n, np.zeros(L * n * n, complex), np.zeros((1, n, n)), inputs(16, cascades=1)[4],
             exact_table(n), trace, blocks=2)
    assert whole_sectors(trace.map_stores, size)


def test_step_plans_refuse_sizes_outside_the_kernel():
    for n in (8, 48, 2048):
        with pytest.raises(ValueError):
            fft_plan.step_rows_plan(n)
        with pytest.raises(ValueError):
            fft_plan.step_cols_plan(n)
