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
the global stores. `row_pass` and `col_pass` take a plan with a split
(`Plan.split`, the strip step's; `tests/test_torch_strip_plan.py`): the S
blocks of a line sum its S parts while they load and take the outputs
S k + e.
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


def layers_of(h0, h0nc, omega, scal, frame, n):
    """`layers(c, y0, rows)` of the row passes: texel::modulate of rows
    y0.. of cascade c, (4, rows, N) complex."""
    cache = {}

    def layers(c, y0, rows):
        if c not in cache:
            cache[c] = modulate(h0[c], h0nc[c], omega[c], scal[c, 0], frame, n)
        return cache[c][:, y0:y0 + rows]
    return layers


def ones_layers(n):
    """Layers of any value, for runs that look only at addresses."""
    return lambda c, y0, rows: np.ones((L, rows, n), complex)


def zeros_scratch(cascades, n):
    """A scratch of any value, for runs that look only at addresses (a
    broadcast view: no memory)."""
    return np.broadcast_to(np.zeros(1, complex), (cascades, n, n, L))


def unit_root(table_n, k):
    """e^{+2 pi i k / N}, k < N, from the N-point half table as the kernels
    read it (step_passes.cuh unit_root): the second half is the first
    negated."""
    half = len(table_n)
    return np.where(k < half, table_n[k % half], -table_n[k % half])


def split_term(z, e, p, split):
    """Term p of block e's pre-stage: z e^{+2 pi i e p / split}, as quarter
    turns."""
    return z * 1j ** ((e * p * (4 // split)) % 4)


def block_order(n, lines, split, blocks):
    """The (first line, parity) of every block of a cascade, in launch
    order, or of its first `blocks`."""
    return [(first, e) for first in range(0, n, lines) for e in range(split)][:blocks]


def row_pass(plan, layers, cascades, table, trace, blocks=None):
    """The row pass of every cascade at N = plan.n * plan.split: the scratch
    (C, R, N, 4) complex, layer l of texel (c, y, k) at [c, y, k, l] (the
    fp32 record (C, N, N, 8) holds its Re and Im at words 2l and 2l + 1);
    R = N, or the rows of the first `blocks` blocks of each cascade.
    `layers(c, y0, rows)` gives the modulated layers (4, rows, N)."""
    m_len, split = plan.n, plan.split
    n = m_len * split
    lines, tps, jp = plan.lines, plan.threads_per_seq, plan.join_pitch
    order = block_order(n, lines, split, blocks)
    scratch = np.full((cascades, max(y0 for y0, _ in order) + lines, n, L), np.nan + 0j)
    seq, t = thread_map(plan, 1)
    i = np.arange(plan.threads)
    table_n = exact_table(n)
    for c in range(cascades):
        for y0, e in order:
            lay = layers(c, y0, lines)
            # thread i takes points i + j B of the block's rows: the
            # pre-stage's sum over the row's `split` parts, then w_N^(e x);
            # layer l of point (r, x) goes to sequence 4 r + l of the join
            # buffer
            words = np.full(plan.seqs * jp, np.nan + 0j)
            for j in range(fft_plan.POINTS // L):
                r, x = (i + j * plan.threads) // m_len, (i + j * plan.threads) % m_len
                point = sum(split_term(lay[:, r, x + p * m_len], e, p, split)
                            for p in range(split)) * unit_root(table_n, e * x)
                for q in range(L):
                    addr = (r * L + q) * jp + x
                    assert np.isnan(words[addr]).all(), "two layers share a join word"
                    words[addr] = point[q]
                    trace.join.append(addr)
            # thread (s, t) loads its points t + m T of sequence s
            block = np.empty((plan.seqs, m_len), complex)
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
            # layers 2h and 2h + 1 of output k = (slot / 2) mod M of row
            # y0 + (slot / 2) / M, h = slot mod 2, at map column split k + e
            for u in range(2 * fft_plan.POINTS // L):
                slot = i + u * plan.threads
                q, h = slot // 2, slot % 2
                y, col = y0 + q // m_len, split * (q % m_len) + e
                w0 = ((q // m_len) * L + 2 * h) * jp + q % m_len
                trace.join.extend([w0, w0 + jp])
                for half, w in enumerate((w0, w0 + jp)):
                    assert np.isnan(scratch[c, y, col, 2 * h + half]).all(), \
                        "two stores share a scratch word"
                    scratch[c, y, col, 2 * h + half] = words[w]
                    assert not np.isnan(scratch[c, y, col, 2 * h + half]).any(), \
                        "a record got a word never written"
                rec = (c * n + y) * n + col
                trace.scratch_stores.append(8 * rec[:, None] + 4 * h[:, None] + np.arange(4))
    assert blocks or not np.isnan(scratch).any(), "a scratch word was never stored"
    return scratch


def col_pass(plan, scratch, foam_in, scal, table, trace, blocks=None):
    """The column pass of every cascade at N = plan.n * plan.split:
    (displacement (C, 3, R, N), normal (C, 4, R, N), foam (C, R, N)) of
    output rows 0..R-1; R = N, or the rows of the first `blocks` blocks of
    each cascade. `scratch[c, y, x, l]` as row_pass leaves it."""
    m_len, split = plan.n, plan.split
    n = m_len * split
    lines, tps, jp, seqs = plan.lines, plan.threads_per_seq, plan.join_pitch, plan.seqs
    cascades = foam_in.shape[0]
    order = block_order(n, lines, split, blocks)
    rows = max(x0 for x0, _ in order) + lines
    disp = np.full((cascades, 3, rows, n), np.nan)
    normal = np.full((cascades, 4, rows, n), np.nan)
    foam = np.full((cascades, rows, n), np.nan)
    s0, t0 = thread_map(plan, 0)
    s1, t1 = thread_map(plan, 1)
    table_n = exact_table(n)
    for c in range(cascades):
        for x0, e in order:
            # stage 0: sequence (column x0 + s / 4, layer s mod 4) fastest;
            # the pre-stage sums the column's `split` parts, one load each
            layer, x = s0 % L, x0 + s0 // L
            block = np.empty((seqs, m_len), complex)
            for m in range(fft_plan.POINTS):
                y = t0 + m * tps
                point = 0
                for p in range(split):
                    point = point + split_term(scratch[c, y + p * m_len, x, layer], e, p, split)
                    rec = (c * n + y + p * m_len) * n + x
                    trace.scratch_loads.append((8 * rec + 2 * layer)[:, None] + np.arange(2))
                block[s0, y] = point * unit_root(table_n, e * y)
            out = run_block(plan, block, table)
            # the join: thread (s, t) writes its outputs t + m T
            words = np.full(seqs * jp, np.nan + 0j)
            for m in range(fft_plan.POINTS):
                addr = s1 * jp + t1 + m * tps
                assert np.isnan(words[addr]).all(), "two outputs share a join word"
                words[addr] = out[s1, t1 + m * tps]
                trace.join.append(addr)
            # ... and unpacks outputs k = t + (layer + 4 j) T of its column
            # into map column split k + e
            layer, col = s1 % L, s1 // L
            kx = x0 + col
            for j in range(fft_plan.POINTS // L):
                k = t1 + (layer + L * j) * tps
                m = split * k + e
                reads = [(col * L + q) * jp + k for q in range(L)]
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


def model_frames(rows, cols, h0, h0nc, omega, foam, scal, frames=1, trace=None):
    """`frames` frames of the pair on plans `rows` and `cols`, foam carried
    from one to the next."""
    trace = Trace() if trace is None else trace
    n = rows.n * rows.split
    table = exact_table(rows.n)
    out = []
    for k in range(frames):
        scratch = row_pass(rows, layers_of(h0, h0nc, omega, scal, k, n), h0.shape[0], table,
                           trace)
        d, nm, foam = col_pass(cols, scratch, foam, scal, table, trace)
        out.append((d, nm))
    return out, foam


def close(got, want):
    return np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_pair_through_its_global_layouts_equals_the_plain_step(n):
    """One frame of 2 cascades: the model equals the plain version (float64
    inputs, float64 maps) to 1e-10 relative."""
    args = inputs(n)
    (out,), foam = model_frames(*plans(n).values(), *args)
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
    out, foam = model_frames(*plans(n).values(), *args, frames=frames, trace=trace)
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
    model_addresses(plans(n), trace)
    assert max(wavefronts(a) for a in trace.join) <= limit


def model_addresses(pair, trace, blocks=2):
    """The first `blocks` blocks of each pass of one cascade on the plans
    `pair` ({"rows": ..., "cols": ...}), on values that do not matter: the
    join, scratch and map addresses into `trace`."""
    rows, cols = pair["rows"], pair["cols"]
    n = rows.n * rows.split
    table = exact_table(rows.n)
    row_pass(rows, ones_layers(n), 1, table, trace, blocks=blocks)
    col_pass(cols, zeros_scratch(1, n), np.broadcast_to(np.zeros(1), (1, n, n)),
             inputs(16, cascades=1)[4], table, trace, blocks=blocks)


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
    model_addresses(plans(n), trace)
    assert whole_sectors(trace.scratch_stores, 4) and whole_sectors(trace.scratch_loads, 4)


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("size", [2, 4])
def test_column_pass_map_stores_whole_sectors(n, size):
    """Each warp's map stores (bf16/f16 or fp32 elements of an output row)
    cover whole 32-byte sectors."""
    trace = Trace()
    model_addresses(plans(n), trace)
    assert whole_sectors(trace.map_stores, size)


def test_step_plans_refuse_sizes_outside_the_kernel():
    for n in (8, 48, 2048):
        with pytest.raises(ValueError):
            fft_plan.step_rows_plan(n)
        with pytest.raises(ValueError):
            fft_plan.step_cols_plan(n)
