"""The port's fused step vs the JAX fused kernel (Pallas, interpret mode).

On the CPU the port's wrappers run their plain PyTorch version; the JAX side
runs `pallas_step.fused_cascade_step` / `fused_cascade_multi_step` through
`pl.pallas_call(interpret=True)`, as tests/test_pallas_step.py does. Both
take the same NumPy inputs. One cascade at N = 128.

Tolerances: fp32 maps <= 1e-4 relative RMS (displacement, normal) and foam
<= 1e-4 RMS; 2-byte maps <= 1e-3 relative RMS displacement and <= 2e-3 RMS
normal (the class tests/test_pallas_step.py uses for 2-byte maps).
"""
import dataclasses
import functools
import subprocess
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from godotoceanwaves_tpu import SimConfig as JaxConfig, default_cascades as jax_cascades
from godotoceanwaves_tpu import init_state as jax_init_state
from godotoceanwaves_tpu.models.ocean import _foam_rates as jax_foam_rates
from godotoceanwaves_tpu.ops import pallas_step

from godotoceanwaves_tpu_torch.models.ocean import _foam_rates
from godotoceanwaves_tpu_torch.ops import _build, fft_plan, fused_step
from godotoceanwaves_tpu_torch.utils import convert

N = 128
DT = np.float32(0.1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - np.asarray(ref, np.float64)) ** 2)))


def host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_maps_close(got, want, two_byte: bool):
    d, nm, foam = got
    wd, wn, wfoam = want
    if two_byte:
        assert rel_rms(host(d), host(wd)) <= 1e-3
        assert rms(host(nm), host(wn)) <= 2e-3
    else:
        assert rel_rms(host(d), host(wd)) <= 1e-4
        assert rel_rms(host(nm), host(wn)) <= 1e-4
    assert rms(host(foam), host(wfoam)) <= 1e-4


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def inputs():
    """One default cascade's state at N = 128 with seeded foam, as NumPy."""
    params = jax.tree.map(lambda x: x[:1], jax_cascades())
    state = jax_init_state(JaxConfig(map_size=N), params)
    foam = np.random.default_rng(0).uniform(0.0, 0.5, (1, N, N)).astype(np.float32)
    leaves = {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}
    leaves["foam"] = foam
    return params, leaves


def _scalars(params, leaves, multi: bool):
    """The same scalar rows for both packages, packed by each one's pack_scalars."""
    t = leaves["time"] + DT
    grow, decay = jax_foam_rates(params, jnp.float32(DT))
    jscal = pallas_step.pack_scalars(jnp.asarray(t), params.tile_length, params.whitecap,
                                     grow, decay, dt=DT if multi else None)
    tp = convert.params_from_numpy(
        {f.name: np.asarray(getattr(params, f.name)) for f in dataclasses.fields(params)},
        device="cpu")
    tgrow, tdecay = _foam_rates(tp, torch.tensor(DT))
    tscal = fused_step.pack_scalars(torch.from_numpy(t), tp.tile_length, tp.whitecap,
                                    tgrow, tdecay, dt=torch.tensor(DT) if multi else None)
    return jscal, tscal


def _jax_args(leaves):
    return tuple(jnp.asarray(leaves[k]) for k in ("h0", "h0nc", "omega", "foam"))


def _torch_args(leaves):
    return tuple(torch.from_numpy(leaves[k].copy()) for k in ("h0", "h0nc", "omega", "foam"))


def test_pack_scalars_matches_jax(inputs):
    for multi in (False, True):
        jscal, tscal = _scalars(*inputs, multi)
        assert tscal.shape == (1, 1, fused_step.NUM_SCALARS)
        np.testing.assert_array_equal(tscal.numpy(), np.asarray(jscal))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_step_matches_jax_kernel(inputs, interpret, dtype):
    jdt, tdt = DTYPES[dtype]
    jscal, tscal = _scalars(*inputs, multi=False)
    want = pallas_step.fused_cascade_step(*_jax_args(inputs[1]), jscal, map_dtype=jdt)
    got = fused_step.fused_cascade_step(*_torch_args(inputs[1]), tscal, map_dtype=tdt)
    assert got[0].shape == (1, 3, N, N) and got[1].shape == (1, 4, N, N)
    assert got[0].dtype == tdt and got[2].dtype == torch.float32
    assert_maps_close(got, want, two_byte=dtype != "float32")


def test_fused_multi_step_matches_jax_kernel(inputs, interpret):
    """K = 2 frames: frame k at t0 + k*dt, foam carried across frames."""
    jscal, tscal = _scalars(*inputs, multi=True)
    want = pallas_step.fused_cascade_multi_step(*_jax_args(inputs[1]), jscal, num_frames=2,
                                                map_dtype=jnp.float32)
    got = fused_step.fused_cascade_multi_step(*_torch_args(inputs[1]), tscal, num_frames=2,
                                              map_dtype=torch.float32)
    assert got[0].shape == (1, 2, 3, N, N) and got[1].shape == (1, 2, 4, N, N)
    for k in range(2):
        assert_maps_close((got[0][:, k], got[1][:, k], got[2]),
                          (want[0][:, k], want[1][:, k], want[2]), two_byte=False)


def test_multi_step_frame_k_equals_single_step_at_its_time(inputs):
    """Frame k of the multi-frame wrapper == a single step at t0 + k*dt with
    the foam of frame k-1: bit-equal on the plain path."""
    _, tscal = _scalars(*inputs, multi=True)
    args = _torch_args(inputs[1])
    d, nm, foam = fused_step.fused_cascade_multi_step(*args, tscal, num_frames=3,
                                                      map_dtype=torch.float32)
    f = args[3]
    for k in range(3):
        row = tscal[:, 0]
        single = tscal.clone()
        single[:, 0, fused_step.S_TIME] = row[:, fused_step.S_TIME] + row[:, fused_step.S_DT] * float(k)
        sd, sn, f = fused_step.fused_cascade_step(*args[:3], f, single, map_dtype=torch.float32)
        assert torch.equal(sd, d[:, k]) and torch.equal(sn, nm[:, k])
    assert torch.equal(f, foam)


def test_cpu_tensors_take_the_plain_version(inputs):
    _, tscal = _scalars(*inputs, multi=False)
    args = _torch_args(inputs[1])
    before = _build.LAUNCHES["fused_step"]
    got = fused_step.fused_cascade_step(*args, tscal, map_dtype=torch.bfloat16)
    want = fused_step.fused_cascade_step_reference(*args, tscal, map_dtype=torch.bfloat16)
    assert _build.LAUNCHES["fused_step"] == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_validates_inputs(inputs):
    _, tscal = _scalars(*inputs, multi=False)
    h0, h0nc, omega, foam = _torch_args(inputs[1])
    with pytest.raises(ValueError, match="omega"):
        fused_step.fused_cascade_step(h0, h0nc, omega[:, :-1], foam, tscal)
    with pytest.raises(TypeError, match="foam"):
        fused_step.fused_cascade_step(h0, h0nc, omega, foam.double(), tscal)
    with pytest.raises(ValueError, match="contiguous"):
        fused_step.fused_cascade_step(h0, h0nc, omega.transpose(1, 2), foam, tscal)
    with pytest.raises(TypeError, match="map_dtype"):
        fused_step.fused_cascade_step(h0, h0nc, omega, foam, tscal, map_dtype=torch.int8)


@pytest.mark.parametrize("n", [8, 2048, 96])
def test_kernel_launcher_rejects_sizes_it_does_not_cover(n):
    """Before building anything, the CUDA launcher refuses N outside the
    power-of-two range 16..1024 and names the strip kernel."""
    meta = lambda *shape: torch.empty(shape, device="meta")
    args = (meta(1, 2, n, n), meta(1, 2, n, n), meta(1, n, n), meta(1, n, n), meta(1, 1, 8))
    with pytest.raises(NotImplementedError, match="pallas_strip"):
        fused_step._launch(*args, num_frames=1, map_dtype=torch.float32, multi=False)


class _Log:
    """Stands in for the kernel library, the streams and the events of the
    multi-frame launch: records every operation in the order made."""

    def __init__(self):
        self.ops = []

    def fused_step_rows(self, *args):
        self.ops.append(("rows", args[-1], args))
        return 0

    def fused_step_cols(self, *args):
        self.ops.append(("cols", args[-1], args))
        return 0

    def stream(self, handle):
        log = self

        class Stream:
            cuda_stream = handle

            def wait_event(self, event):
                log.ops.append(("wait", handle, event))

        return Stream()

    def event_class(self):
        log = self

        class Event:
            def record(self, stream):
                log.ops.append(("record", stream.cuda_stream, self))

        return Event


def _reaches(ops):
    """reach[j]: the operations that operation j waits for, on the device:
    the one before it on its stream, and the last record of an event it waits on."""
    reach, last_on, recorded = [], {}, {}
    for j, (kind, stream, arg) in enumerate(ops):
        before = set()
        for i in ([last_on[stream]] if stream in last_on else []) + (
                [recorded[id(arg)]] if kind == "wait" else []):
            before |= reach[i] | {i}
        reach.append(before)
        last_on[stream] = j
        if kind == "record":
            recorded[id(arg)] = j
    return reach


@pytest.mark.parametrize("cascades,frames,depth,dtype", [(4, 7, 3, torch.bfloat16),
                                                         (3, 2, 3, torch.float32),
                                                         (1, 5, 2, torch.float16)])
def test_multi_frame_launch_pipelines_row_passes_ahead_of_column_passes(
        monkeypatch, cascades, frames, depth, dtype):
    """The multi-frame launch makes each frame's row pass (all cascades) on
    the row stream into scratch k mod depth and its column pass on the
    caller's stream, frames in order, each once. On the device: a column
    pass runs after its frame's row pass and the column pass before it (the
    foam chain); a row pass overwrites a scratch only after every earlier
    column pass that reads it; the row stream starts after what the caller's
    stream held and joins it before the call returns. Pointers: the batched
    pair's, at frame k's maps."""
    n = 16
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt)
    h0, h0nc, omega = z(cascades, 2, n, n), z(cascades, 2, n, n), z(cascades, n, n)
    foam, foam_out, scal = z(cascades, n, n), z(cascades, n, n), z(cascades, 1, 8)
    scratches = [z(cascades, n, n, 2 * fft_plan.LAYERS) for _ in range(depth)]
    tw = z(n // 2, 2)
    disp, normal = z(cascades, frames, 3, n, n, dt=dtype), z(cascades, frames, 4, n, n, dt=dtype)
    plans = fft_plan.step_rows_plan(n), fft_plan.step_cols_plan(n)
    log, before = _Log(), _build.LAUNCHES["fused_step"]
    monkeypatch.setattr(torch.cuda, "Event", log.event_class())
    monkeypatch.setattr(_build, "load", lambda: log)
    log.ops.append(("cols", 1, None))          # earlier work on the caller's stream
    fused_step._launch_frames(log.stream(1), log.stream(2), h0, h0nc, omega, foam, scal,
                              tw, scratches, disp, normal, foam_out, plans, dtype)
    log.ops.append(("cols", 1, None))          # later work on the caller's stream
    ops, reach = log.ops, _reaches(log.ops)
    assert _build.LAUNCHES["fused_step"] == before + 2 * frames
    assert fused_step.frame_pipeline(frames, depth) == [
        (k, k % depth, k - depth if k >= depth else None) for k in range(frames)]
    rows = [j for j, op in enumerate(ops) if op[0] == "rows"]
    cols = [j for j, op in enumerate(ops) if op[0] == "cols"][1:-1]
    assert len(rows) == len(cols) == frames
    assert all(ops[j][1] == 2 for j in rows) and all(ops[j][1] == 1 for j in cols)
    ptr = lambda t: t.data_ptr()
    for k, (r, c) in enumerate(zip(rows, cols)):
        s = ptr(scratches[k % depth])
        assert ops[r][2] == (ptr(h0), ptr(h0nc), ptr(omega), ptr(scal), ptr(tw), s, cascades, n,
                             k, plans[0].lines, plans[0].pitch, plans[0].join_pitch, 2)
        assert ops[c][2] == (s, ptr(foam if k == 0 else foam_out), ptr(scal), ptr(tw),
                             ptr(disp[:, k]), ptr(normal[:, k]), ptr(foam_out), cascades, n,
                             fused_step.DTYPE_CODES[dtype], frames * 3 * n * n,
                             frames * 4 * n * n, plans[1].lines, plans[1].pitch,
                             plans[1].join_pitch, 1)
        assert r in reach[c] and (k == 0 or cols[k - 1] in reach[c])
        assert all(cols[j] in reach[r] for j in range(k) if j % depth == k % depth)
        assert 0 in reach[r]
    assert set(rows) <= reach[-1]


def test_row_stream_is_one_of_its_own_a_thread_and_device(monkeypatch):
    """The row passes' stream comes from the kernel library, once for each
    thread and device: the same thread gets the same stream back, another
    thread a stream of its own."""
    made = []

    class Lib:
        @staticmethod
        def fused_step_stream(out):
            made.append(len(made) + 1)
            out._obj.value = made[-1]
            return 0

    monkeypatch.setattr(torch.cuda, "ExternalStream",
                        lambda handle, device: (handle, device.index))
    monkeypatch.setattr(fused_step, "_row_streams", threading.local())
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    mine = [fused_step._row_stream(Lib, d) for d in (dev0, dev1, dev0)]
    theirs = []
    worker = threading.Thread(target=lambda: theirs.append(fused_step._row_stream(Lib, dev0)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert mine == [(1, 0), (2, 1), (1, 0)] and theirs == [(3, 0)]


def test_import_builds_nothing():
    """Importing the package neither compiles nor loads the CUDA library."""
    code = ("import subprocess\n"
            "def refuse(*args, **kwargs):\n"
            "    raise AssertionError('the import started a process')\n"
            "subprocess.Popen = subprocess.run = refuse\n"
            "import godotoceanwaves_tpu_torch, godotoceanwaves_tpu_torch.ops.fused_step\n"
            "from godotoceanwaves_tpu_torch.ops import _build\n"
            "assert _build._load.cache_info().currsize == 0\n"
            "assert not _build.LAUNCHES\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
