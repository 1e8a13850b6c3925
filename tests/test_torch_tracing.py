"""The port's span-and-counter recorder (`utils/observability.py`) and the
spans and counters at its layers.

On the CPU: tracing off records nothing and touches neither the clock nor
a profiler range; on, the nesting, parents and self times of a planted
tree, on the clock of `time.perf_counter_ns`; the spans under
`torch.profiler`; the session's, the stream's, the pipeline's and the
sharded step's spans and counters; the kernel launches as counters;
`profiling.trace`'s `spans.json` beside its trace. The tests marked `cuda` hold the graphs'
counters and the pipeline's wait on the card; they skip here. This file
imports only numpy, torch and the port. On the card:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest
"""
import collections
import json
import sys
import threading
import time
import types

import pytest
import torch

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models.viewport import FramePipeline, SceneRenderer, SpraySession
from godotoceanwaves_tpu_torch.ops import _build, fft_plan, fused_step
from godotoceanwaves_tpu_torch.parallel import sharding
from godotoceanwaves_tpu_torch.utils import MapStreamer, graphs, observability, profiling

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh():
    observability.reset()
    yield
    observability.reset()


def _raise(*args, **kwargs):
    raise AssertionError("touched while tracing is off")


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    ocean = T.Ocean(map_size=16, device="cpu", updates_per_second=0)
    ocean.update(1 / 60)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(observability, "time", types.SimpleNamespace(perf_counter_ns=_raise))
    assert observability.span("a") is observability.span("b")      # one shared no-op
    with observability.span("a"):
        observability.count("c", 3)
    for _ in range(3):
        ocean.update(1 / 60)
    streamer = MapStreamer(lambda: ocean.update(1 / 60))
    assert len(list(streamer.stream(num_frames=2))) == 2
    pipe = FramePipeline()
    pipe.push(torch.zeros((4, 4, 3), dtype=torch.uint8))
    pipe.flush()
    snap = observability.snapshot()
    assert snap == {"spans": {}, "counters": {}} and observability.spans() == []


def test_nesting_parents_and_self_time_on_a_planted_tree():
    with observability.tracing():
        with observability.span("root"):
            time.sleep(0.010)
            with observability.span("a"):
                time.sleep(0.020)
            with observability.span("b"):
                time.sleep(0.005)
                with observability.span("c"):
                    time.sleep(0.005)
            observability.count("n", 2)
            observability.count("n")
    snap = observability.snapshot()
    spans = snap["spans"]
    assert {k: v["count"] for k, v in spans.items()} == {"root": 1, "a": 1, "b": 1, "c": 1}
    parents = {r.name: r.parent for r in observability.spans()}
    assert parents == {"root": None, "a": "root", "b": "root", "c": "b"}
    ms = {k: v["total_ms"] for k, v in spans.items()}
    assert ms["root"] >= 40 and ms["a"] >= 20 and ms["b"] >= 10 and ms["c"] >= 5
    assert spans["root"]["self_ms"] == pytest.approx(ms["root"] - ms["a"] - ms["b"], abs=1e-6)
    assert spans["b"]["self_ms"] == pytest.approx(ms["b"] - ms["c"], abs=1e-6)
    assert spans["a"]["self_ms"] == ms["a"] and spans["root"]["self_ms"] >= 10
    assert spans["a"]["p50_ms"] == spans["a"]["p99_ms"] == pytest.approx(ms["a"])
    assert snap["counters"] == {"n": 3}
    rec = {r.name: r for r in observability.spans()}
    for child, parent in (("a", "root"), ("b", "root"), ("c", "b")):
        assert rec[parent].start_ns <= rec[child].start_ns <= rec[child].end_ns
        assert rec[child].end_ns <= rec[parent].end_ns
    assert len({r.thread for r in rec.values()}) == 1


def test_spans_are_profiler_ranges_with_their_nesting():
    def work():
        with observability.span("outer"):
            with observability.span("inner"):
                torch.ones(8) + 1
            observability.count("k")
    events = _profiled(work)
    names = [e.name for e in events]
    assert names.count("outer") == 1 and names.count("inner") == 1
    inner = next(e for e in events if e.name == "inner")
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "outer"
    add = next(e for e in events if e.name == "aten::add")
    parent = add
    while parent.cpu_parent is not None and parent.name != "inner":
        parent = parent.cpu_parent
    assert parent.name == "inner"
    assert observability.snapshot()["counters"] == {"k": 1}
    assert observability.span("after") is observability.span("the profiler")   # off again


def test_a_span_under_the_profiler_is_a_fast_range(monkeypatch):
    """A span enters torch's fast range, not `record_function` (seven times
    its cost, and a device shadow besides)."""
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)

    def work():
        with observability.span("fast"):
            torch.ones(4) * 2
    events = _profiled(work)
    assert [e.name for e in events].count("fast") == 1
    assert observability.snapshot()["spans"]["fast"]["count"] == 1


def test_spans_read_the_clock_of_perf_counter():
    """The ring's readings are `time.perf_counter_ns`, the host clock a
    caller's own `perf_counter` readings are on."""
    with observability.tracing():
        before = time.perf_counter_ns()
        with observability.span("timed"):
            time.sleep(0.002)
        after = time.perf_counter_ns()
    (r,) = observability.spans()
    assert before <= r.start_ns and r.start_ns + 2_000_000 <= r.end_ns <= after


def test_session_spans_and_counters():
    ocean = T.Ocean(map_size=16, device="cpu", updates_per_second=10)
    with observability.tracing():
        assert ocean.update(1 / 60) is not None
    snap = observability.snapshot()
    assert set(snap["spans"]) == {"ocean.update", "ocean.step", "step.scalars"}
    parents = {r.name: r.parent for r in observability.spans()}
    assert parents == {"ocean.update": None, "ocean.step": "ocean.update",
                       "step.scalars": "ocean.step"}
    assert snap["counters"] == {}
    step = snap["spans"]["ocean.step"]
    assert snap["spans"]["ocean.update"]["self_ms"] < snap["spans"]["ocean.update"]["total_ms"]
    assert step["self_ms"] < step["total_ms"]

    observability.reset()
    with observability.tracing():
        assert ocean.update(1 / 60) is None          # the rate limiter skips it
    snap = observability.snapshot()
    assert set(snap["spans"]) == {"ocean.update"}
    assert snap["counters"] == {"ocean.skipped": 1}


def test_regeneration_and_the_staged_step_are_spans():
    ocean = T.Ocean(map_size=16, device="cpu", updates_per_second=0, fused="never")
    ocean.set_cascade(1, wind_speed=12.0)
    with observability.tracing():
        ocean.update(1 / 60)
        ocean.update(1 / 60)
    snap = observability.snapshot()
    assert snap["counters"] == {"ocean.regenerated": 1}
    assert snap["spans"]["ocean.regenerate"]["count"] == 1
    assert snap["spans"]["step.staged"]["count"] == 2
    parents = {(r.name, r.parent) for r in observability.spans()}
    assert ("ocean.regenerate", "ocean.update") in parents
    assert ("step.staged", "ocean.step") in parents


def test_map_streamer_counts_frames_and_host_bytes():
    ocean = T.Ocean(map_size=16, device="cpu", updates_per_second=0)
    with observability.tracing():
        frames = list(MapStreamer(lambda: ocean.update(1 / 60)).stream(num_frames=3))
    snap = observability.snapshot()
    host = sum(a.nbytes for f in frames for a in f.values())
    assert host == 3 * ocean.num_cascades * 7 * 16 * 16 * 4       # fp32 on the host
    assert snap["counters"] == {"stream.host_bytes": host}
    spans = snap["spans"]
    assert spans["stream.step"]["count"] == spans["stream.copy_issue"]["count"] == 3
    assert spans["stream.convert"]["count"] == 3
    assert "stream.wait" not in spans                 # a CPU frame has nothing to wait on
    assert ("ocean.update", "stream.step") in {(r.name, r.parent)
                                               for r in observability.spans()}


def test_frame_pipeline_counts_frames_and_bytes():
    pipe = FramePipeline()
    img = torch.zeros((6, 8, 3), dtype=torch.uint8)
    with observability.tracing():
        for _ in range(3):
            pipe.push(img)
        pipe.flush()
    snap = observability.snapshot()
    assert snap["counters"] == {"pipeline.frames": 3, "pipeline.bytes": 3 * img.nbytes}
    assert snap["spans"]["pipeline.push"]["count"] == 3


def test_sharded_step_spans_keep_their_names():
    mesh = sharding.build_mesh([CPU] * 4, rows=2)
    cfg = T.SimConfig(map_size=32)
    params = sharding.multipatch_params(T.default_cascades(device="cpu"), num_patches=2)
    state = sharding.make_multichip_init(mesh, cfg)(params)
    step = sharding.make_multichip_step(mesh, cfg)
    names = {e.name for e in _profiled(lambda: step(state, params, 0.05))}
    assert {"sharded/modulate", "sharded/rows_dft", "sharded/exchange",
            "sharded/unpack"} <= names
    # two row passes a rows group, one group a patch
    assert observability.snapshot()["spans"]["sharded/rows_dft"]["count"] == 2 * 2


def test_launch_deltas_count_only_while_on(monkeypatch):
    """A launch counts as `launches.<op>` where `_build.launch` counts it in
    `LAUNCHES`, and a replay as its capture's tally (`_build.made`)."""
    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(
        fused_step_rows=lambda: 0))
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())
    launch = lambda: _build.launch("fused_step", "fused_step_rows")
    launch()                                            # off: not counted
    with observability.tracing():
        launch()
        with observability.span("x"):
            launch()
        _build.made({"fused_step": 3})                  # a replay of a graph of 3
    launch()                                            # off again
    assert observability.snapshot()["counters"] == {"launches.fused_step": 5}
    assert _build.LAUNCHES == {"fused_step": 7}


def test_multi_frame_launch_counts_each_pass_of_both_streams(monkeypatch):
    """The multi-frame launch's row passes (on their own stream) and column
    passes count as `launches.fused_step`, 2 a frame."""
    class Lib:
        fused_step_rows = fused_step_cols = staticmethod(lambda *args: 0)

    monkeypatch.setattr(_build, "load", lambda: Lib)

    class Stream:
        cuda_stream = 0
        wait_event = staticmethod(lambda event: None)

    monkeypatch.setattr(torch.cuda, "Event", lambda: types.SimpleNamespace(
        record=lambda stream: None))
    z = lambda *shape: torch.zeros(shape)
    n, c, k = 16, 2, 5
    with observability.tracing():
        fused_step._launch_frames(
            Stream, Stream, z(c, 2, n, n), z(c, 2, n, n), z(c, n, n), z(c, n, n),
            z(c, 1, 8), z(n // 2, 2), [z(c, n, n, 8)] * 3, z(c, k, 3, n, n), z(c, k, 4, n, n),
            z(c, n, n), (fft_plan.step_rows_plan(n), fft_plan.step_cols_plan(n)), torch.float32)
    assert observability.snapshot()["counters"] == {"launches.fused_step": 2 * k}


def test_the_ring_keeps_the_last_spans(monkeypatch):
    monkeypatch.setattr(observability, "RING", 8)
    observability.reset()
    with observability.tracing():
        for i in range(20):
            with observability.span(f"s{i}"):
                pass
    assert [r.name for r in observability.spans()] == [f"s{i}" for i in range(12, 20)]
    spans = observability.snapshot()["spans"]
    assert len(spans) == 20                         # the totals keep every name
    assert spans["s0"]["count"] == 1 and spans["s0"]["p50_ms"] is None
    assert spans["s19"]["p99_ms"] == pytest.approx(spans["s19"]["total_ms"])


def test_counts_and_spans_from_many_threads_lose_nothing():
    threads, each = 12, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with observability.span("t.outer"):
                    with observability.span("t.inner"):
                        observability.count("t.n")

        with observability.tracing():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    snap = observability.snapshot()
    assert snap["counters"] == {"t.n": threads * each}
    assert snap["spans"]["t.inner"]["count"] == snap["spans"]["t.outer"]["count"] == threads * each
    assert all(r.parent == "t.outer" for r in observability.spans() if r.name == "t.inner")


def test_profiling_trace_writes_spans_on_the_chrome_timeline(tmp_path):
    """`spans.json` holds the block's snapshot, and the Chrome trace holds
    each span as a range of its name, nested as the ring has it."""
    ocean = T.Ocean(map_size=16, device="cpu", updates_per_second=0)
    with observability.tracing():
        observability.count("before the block")
    with profiling.trace(str(tmp_path), device="cpu"):
        for _ in range(3):
            ocean.update(1 / 60)
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans == json.loads(json.dumps(observability.snapshot()))
    assert spans["spans"]["ocean.update"]["count"] == spans["spans"]["ocean.step"]["count"] == 3
    assert spans["counters"] == {}                      # reset when the block opened
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {name: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                           if e.get("name") == name and e.get("ph") == "X")
              for name in ("ocean.update", "ocean.step", "step.scalars")}
    assert {k: len(v) for k, v in ranges.items()} == {k: 3 for k in ranges}
    for outer, inner in (("ocean.update", "ocean.step"), ("ocean.step", "step.scalars")):
        for (s0, e0), (s1, e1) in zip(ranges[outer], ranges[inner]):
            assert s0 <= s1 and e1 <= e0


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs and the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_steady_render_replay_counts_one_replay_and_its_copies(card):
    ocean = T.Ocean(map_size=64, device=card, updates_per_second=0)
    maps = ocean.update(1 / 60)
    scales = ocean.params.map_scales()
    renderer = SceneRenderer(128, 72, mesh_quality="low")
    args = (maps, scales, ocean.water_color, ocean.foam_color, (0.0, 12.0, 0.0), -12.0, 30.0)
    for _ in range(2):
        renderer.render(*args)                     # the capture, then one replay
    torch.cuda.synchronize()
    with observability.tracing():
        renderer.render(*args)
    torch.cuda.synchronize()
    snap = observability.snapshot()
    # the input leaves: the maps, the scales, and the staged host numbers
    # (two colours, the position: 3 fp32 each; pitch, yaw, fov: 1 each)
    leaves = maps.displacement.nbytes + maps.normal.nbytes + scales.nbytes + 4 * 12
    assert snap["spans"]["graph.launch"]["count"] == 1 and "graph.capture" not in snap["spans"]
    assert snap["counters"]["graph.copy_in_bytes"] == leaves
    assert snap["counters"]["graph.copy_out_bytes"] == 128 * 72 * 3
    parents = {(r.name, r.parent) for r in observability.spans()}
    assert {("graph.render", "render.frame"), ("graph.copy_in", "graph.render"),
            ("graph.launch", "graph.render"), ("graph.copy_out", "graph.render")} <= parents
    assert {k: v for k, v in snap["counters"].items() if k.startswith("launches.")} == {
        "launches.tap": 1, "launches.fan": 1}


@pytest.mark.cuda
def test_the_frame_loop_counts_frames_waits_and_kernels_on_the_card(card):
    ocean = T.Ocean(map_size=64, device=card, updates_per_second=0)
    spray = SpraySession(1024, device=card)
    renderer = SceneRenderer(128, 72, mesh_quality="low")
    pipe = FramePipeline()
    scales = ocean.params.map_scales()

    def frame():
        maps = ocean.update(1 / 60)
        attrs = spray.advance(maps, scales, 1 / 60)
        img = renderer.render(maps, scales, ocean.water_color, ocean.foam_color,
                              (0.0, 12.0, 0.0), -12.0, 30.0, spray_attrs=attrs)
        return pipe.push(img)

    for _ in range(3):
        frame()
    with observability.tracing():
        for _ in range(4):
            frame()
        pipe.flush()
    torch.cuda.synchronize()
    snap = observability.snapshot()
    counters, spans = snap["counters"], snap["spans"]
    assert counters["pipeline.frames"] == 5 and spans["pipeline.wait"]["count"] == 5
    assert counters["pipeline.bytes"] == 5 * 128 * 72 * 3
    assert spans["graph.launch"]["count"] == 4 and "graph.capture" not in spans
    assert spans["kernel.fused_step"]["count"] == 4 and spans["kernel.spray"]["count"] == 4
    assert {k: v for k, v in counters.items() if k.startswith("launches.")} == {
        "launches.fused_step": 8, "launches.tap": 4, "launches.splat": 4, "launches.fan": 4,
        "launches.spray": 4}
    assert {("kernel.fused_step", "ocean.step"), ("kernel.spray", "spray.advance"),
            ("graph.render_spray", "render.frame")} <= {(r.name, r.parent)
                                                         for r in observability.spans()}


@pytest.mark.cuda
def test_the_multi_frame_launch_counts_its_launches_eager_and_replayed(card):
    """A 48-frame `step_frames` call at 64^2: one `kernel.fused_step` span
    around the launch, both streams' passes inside it; `launches.fused_step`
    96 a call, eager and as a graph replay's tally."""
    from godotoceanwaves_tpu_torch.models.ocean import step_frames
    ocean = T.Ocean(map_size=64, device=card, updates_per_second=0)

    def frames48(state, params):
        return step_frames(ocean.config, state, params, 0.02, 48)

    args = (ocean.state, ocean.params)
    graphed = graphs.graphed(frames48)
    for _ in range(2):
        graphed(*args)                             # the eager first call and the capture
    torch.cuda.synchronize()
    with observability.tracing():
        frames48(*args)
        torch.cuda.synchronize()
        eager = observability.snapshot()
        observability.reset()
        graphed(*args)
        torch.cuda.synchronize()
        replay = observability.snapshot()
    assert eager["spans"]["kernel.fused_step"]["count"] == 1
    assert eager["counters"]["launches.fused_step"] == 96
    assert replay["counters"]["launches.fused_step"] == 96
    assert "kernel.fused_step" not in replay["spans"]
