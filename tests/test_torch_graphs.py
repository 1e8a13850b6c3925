"""`utils/graphs.py`, the port's counterpart of `jax.jit`, on the CPU.

A capture needs the card (`tests/test_torch_cuda.py` holds every graphed
program against `graphs.disabled()` there). Here: a graphed callable on CPU
tensors runs its function as it is; the key separates what `jax.jit`
retraces on; `disabled()` nests; the launch call (`ops/_build.py`) against
a fake library; the launch tally and the kept constants of a capture; the
results a replay hands back. And the frame programs the port captures
(the render with and without spray, the spray step, the K-frame step, the
ANSI field, the "mxu" gradient taps) make no host read on the card's route,
checked on the CPU by a torch function mode that raises on every read of a
tensor's value (the gradient-tap kernel, which has no CPU mode, is stood in
for by zeros of its output's shape).
"""
import collections
import dataclasses
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import geometry, shading, spray
from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
from godotoceanwaves_tpu_torch.models.viewport import (RENDER_TIERS, SceneRenderer,
                                                       SpraySession, make_batched_step)
from godotoceanwaves_tpu_torch.ops import _build, tap
from godotoceanwaves_tpu_torch.utils import graphs, live


def spec(*args, **kwargs):
    return graphs._flatten((args, kwargs), [])


def test_graphed_on_cpu_runs_the_function_as_it_is():
    seen = []

    def fn(x, scale, *, shift=0.0):
        seen.append((x, scale, shift))
        return {"y": x * scale + shift, "same": x}

    g = graphs.graphed(fn)
    x = torch.arange(6.0).reshape(2, 3)
    out = g(x, 2.0, shift=np.float32(1.0))        # a NumPy static is fine here
    assert seen[0][0] is x and out["same"] is x
    assert torch.equal(out["y"], x * 2 + 1)
    assert g.num_graphs == 0 and g.capture_seconds == []


@pytest.mark.parametrize("a,b", [
    ((torch.zeros(3, 4),), (torch.zeros(4, 3),)),
    ((torch.zeros(3, 4),), (torch.zeros(3, 4, dtype=torch.bfloat16),)),
    ((torch.zeros(3), 0.5), (torch.zeros(3), 0.25)),
    ((torch.zeros(3), "high"), (torch.zeros(3), "low")),
    (({"a": torch.zeros(2)},), ({"b": torch.zeros(2)},)),
    ((torch.zeros(2), None), (torch.zeros(2), torch.zeros(2))),
], ids=["shape", "dtype", "number", "string", "dict-key", "none-vs-tensor"])
def test_key_separates_shapes_dtypes_and_static_values(a, b):
    assert spec(*a) != spec(*b)
    assert hash(spec(*a)) == hash(spec(*a))


def test_key_ignores_tensor_values_and_layout():
    x = torch.randn(4, 6)
    assert spec(x, 1.0) == spec(torch.zeros(4, 6), 1.0)
    assert spec(x.T.contiguous().T, 1.0) == spec(x, 1.0)


def test_flatten_and_unflatten_round_trip_the_ports_containers():
    maps = OceanMaps(displacement=torch.randn(2, 3, 4, 4), normal=torch.randn(2, 4, 4, 4))
    params = spray.SprayParams(num_particles=16)
    tree = (maps, params, {"k": [torch.ones(2), 3]}, (None, "s"))
    leaves = []
    sp = graphs._flatten(tree, leaves)
    assert len(leaves) == 3 and leaves[0] is maps.displacement
    back = graphs._unflatten(sp, iter(leaves))
    assert isinstance(back[0], OceanMaps) and back[0].normal is maps.normal
    assert back[1] == params and dataclasses.is_dataclass(back[1])
    assert back[2]["k"][1] == 3 and back[2]["k"][0] is leaves[2] and back[3] == (None, "s")


def test_disabled_nests_and_restores():
    assert graphs.enabled()
    with graphs.disabled():
        assert not graphs.enabled()
        with graphs.disabled():
            assert not graphs.enabled()
        assert not graphs.enabled()
    assert graphs.enabled()
    with pytest.raises(KeyError):
        with graphs.disabled():
            raise KeyError("x")
    assert graphs.enabled()


class FakeSymbol:
    """A library entry that records its calls and returns `rc`."""

    def __init__(self):
        self.calls, self.rc = [], 0

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class FakeLib:
    """Stands in for `ctypes.CDLL`: every symbol is a `FakeSymbol`."""

    def __init__(self, path):
        self.path, self.symbols = path, {}

    def __getattr__(self, name):
        return self.symbols.setdefault(name, FakeSymbol())


@pytest.fixture
def fake_lib(monkeypatch):
    """`_build.load()` returns a `FakeLib`, loaded as the real library is;
    `_build.LAUNCHES` starts empty."""
    monkeypatch.setattr(_build, "compile_library", lambda: (Path("fake.so"), ""))
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    _build._load.cache_clear()
    try:
        yield _build.load()
    finally:
        _build._load.cache_clear()


def test_launch_calls_the_symbol_raises_on_its_error_and_counts(fake_lib):
    """`_build.launch` calls the library's symbol with the arguments; a
    nonzero return raises with the symbol and the CUDA error and counts
    nothing; outside a capture a launch counts 1 for its op, inside one it
    goes to the capture's tally only, and a replay of that tally counts it."""
    _build.launch("tap", "lod_tap", 1, 2)
    assert fake_lib.lod_tap.calls == [(1, 2)] and _build.LAUNCHES == {"tap": 1}
    fake_lib.march_heightfield.rc = 700
    with pytest.raises(RuntimeError, match="march_heightfield launch failed: cudaError 700"):
        _build.launch("march", "march_heightfield")
    assert _build.LAUNCHES == {"tap": 1}
    tally = collections.Counter()
    with _build.recording(tally):
        _build.launch("tap", "lod_tap")
        _build.launch("fan", "fan_bracket")
        _build.launch("tap", "lod_tap")
    assert tally == {"tap": 2, "fan": 1} and _build.LAUNCHES == {"tap": 1}
    seen = []
    other = threading.Thread(target=lambda: seen.append(_build.launch("fan", "fan_bracket")))
    with _build.recording(collections.Counter()):
        other.start()                # another thread's launch is made, not recorded
        other.join(timeout=60)
    assert not other.is_alive() and seen == [None]
    _build.made(tally)
    _build.made(tally)
    assert _build.LAUNCHES == {"tap": 5, "fan": 3}


def test_a_capture_tallies_launches_and_keeps_cached_constants(fake_lib):
    """Outside a capture a launch counts 1; inside one it counts 0 and goes
    to the capture's tally, which each replay adds; a cached constant read
    during a capture is held by it."""
    _build.launch("tap", "lod_tap")
    assert _build.LAUNCHES == {"tap": 1}
    capture = graphs._Capture()
    graphs._state.capture = capture
    try:
        with _build.recording(capture.tally):
            _build.launch("tap", "lod_tap")
            _build.launch("tap", "lod_tap")
            const = shading._const((0.25, 0.5, 0.75), torch.device("cpu"))
    finally:
        graphs._state.capture = None
    assert capture.tally == {"tap": 2} and _build.LAUNCHES == {"tap": 1}
    assert any(k is const for k in capture.kept)
    _build.made(capture.tally)
    assert _build.LAUNCHES == {"tap": 3}


def test_results_hand_back_passed_through_inputs_and_copy_the_rest():
    inputs = [torch.zeros(3), torch.ones(2)]
    args = [torch.full((3,), 7.0), torch.full((2,), 9.0)]
    fresh = torch.arange(4.0)
    leaves = []
    out_spec = graphs._flatten({"state": inputs[0], "frame": fresh}, leaves)
    out = graphs._results(out_spec, leaves, inputs, args)
    assert out["state"] is args[0]                 # the caller's own tensor
    assert torch.equal(out["frame"], fresh) and out["frame"].data_ptr() != fresh.data_ptr()


class NoHostRead(TorchFunctionMode):
    """Raises on every read of a tensor's value into Python."""
    READS = {"__bool__", "item", "tolist", "__float__", "__int__", "__index__", "numpy", "cpu"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.READS:
            raise RuntimeError(f"host read: {func.__name__}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def frame_inputs():
    ocean = T.Ocean(map_size=32, updates_per_second=0, device="cpu")
    maps = ocean.update(1 / 30)
    params, state = SpraySession(num_particles=64, device="cpu").ensure_init()
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    pose = (t(ocean.water_color), t(ocean.foam_color), t([1.0, 8.0, -2.0]), t(-12.0), t(5.0),
            t(70.0))
    return ocean, maps, ocean.params.map_scales(), params, state, pose


PROGRAMS = ("render", "render_spray", "spray_step", "batched", "field", "gradient_mxu")


@pytest.mark.parametrize("program", PROGRAMS)
def test_frame_programs_make_no_host_read_on_the_cards_route(frame_inputs, program,
                                                             monkeypatch):
    """What the card captures reads no value back to the host (a host read
    would abort a capture): the "mxu" sampler, and the gradient-tap kernel's
    route, its launch stood in for by zeros."""
    monkeypatch.setattr(geometry, "_resolve_tap_impl", lambda impl, dev: "pallas")
    monkeypatch.setattr(tap, "gradient_lod_tap",
                        lambda pyr, sc, xz, lev: torch.zeros(xz.shape[:-1] + (3,)))
    ocean, maps, scales, params, state, pose = frame_inputs
    r = SceneRenderer(48, 32, mesh_quality="low", sampler="mxu", **RENDER_TIERS["interactive"])
    now = torch.tensor(0.5)
    calls = {
        "render": lambda: r._render(maps, scales, *pose),
        "render_spray": lambda: r._render_spray(
            maps, scales, *pose, spray.spray_step(params, state, maps, scales, now)[1]),
        "spray_step": lambda: spray.spray_step(params, state, maps, scales, now),
        "batched": lambda: make_batched_step(r, ocean.config, params, 2).program.fn(
            ocean.state, ocean.params, state, now, *pose, 1 / 30),
        "field": lambda: live._sample_field(maps, scales, 88.0, 12, 6),
        "gradient_mxu": lambda: shading.cascade_gradient(
            maps.normal, scales, torch.rand(5, 7, 2) * 200 - 100, sampler="mxu"),
    }
    with NoHostRead():
        out = calls[program]()
    leaves = []
    graphs._flatten(out, leaves)
    assert leaves and all(bool(t.isfinite().all()) for t in leaves if t.is_floating_point())


def test_no_host_read_mode_catches_a_host_read():
    with pytest.raises(RuntimeError, match="host read"):
        with NoHostRead():
            bool(torch.ones(()) > 0)
