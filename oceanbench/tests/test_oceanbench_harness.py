"""The harness's arithmetic on hand values, its trace reduction on synthetic
events, its refusal without a card, and every cell driven on the CPU at a
tiny size."""
import json
import subprocess
import sys
import types

import pytest

from oceanbench.core import clock, harness, manifest, records, roofline, trace
from oceanbench.tests import tiny

CELLS = tiny.workload_names()


def test_frame_ms_and_p95_on_synthetic_arrivals():
    arrivals = [10.0 + 0.020 * i for i in range(101)]        # 20 ms apart
    arrivals[50] += 0.030                                      # one stall: 50 ms then -10
    gaps = clock.intervals_ms(arrivals)
    assert len(gaps) == 100
    assert clock.window_ms(10.0, 12.5, 100) == pytest.approx(25.0)
    # inclusive quantiles of 98 gaps of 20, one of 50 and one of -10 (ms)
    assert clock.p95(gaps) == pytest.approx(20.0)
    # 90 of 20 ms and 40..49: position 0.95 x 99 = 94.05 of the sorted gaps, 44 to 45
    stalls = [20.0] * 90 + [40.0 + i for i in range(10)]
    assert clock.p95(stalls) == pytest.approx(44.05)


def test_roofline_counts_by_hand():
    # 3 x 1024^2, bf16 maps: in 24 B a texel, out 7 x 2 + 4 = 18 B; 8 fp32 scalars a cascade
    assert roofline.step_bytes(3, 1024, "bfloat16") == 3 * (1024 * 1024 * 42 + 32)
    assert roofline.step_bytes(2, 2048, "bfloat16") == 2 * (2048 * 2048 * 42 + 32)
    assert roofline.fft_flops(1024, 3 * 8 * 1024) == 5 * 1024 * 10 * 3 * 8 * 1024
    ms, by = roofline.step_bound(3, 1024, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(132120672 / 3.35e9)
    ms, by = roofline.step_bound(2, 2048, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(352321600 / 3.35e9)
    assert ms == pytest.approx(0.10517, abs=1e-5)


def _ev(name, start, end, device=False, id=0, thread=1, meta=None):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end), id=id,
        thread=thread, device_type=types.SimpleNamespace(name="CUDA" if device else "CPU"),
        metadata_json=meta)


def test_trace_summary_on_synthetic_events():
    events = [
        _ev(trace.WINDOW, 0.0, 1000.0),
        _ev("oceanbench.render", 10.0, 30.0), _ev("cudaGraphLaunch", 12.0, 20.0, id=7),
        _ev("aten::mul", 11.0, 21.0, id=7),          # an op sharing the id: counted once
        _ev("oceanbench.render", 500.0, 520.0), _ev("cudaGraphLaunch", 505.0, 510.0, id=9),
        _ev("aten::copy_", 600.0, 900.0), _ev("cudaMemcpyAsync", 610.0, 615.0, id=11),
        _ev("k_a", 100.0, 300.0, device=True, id=7), _ev("k_b", 250.0, 400.0, device=True, id=7),
        _ev("k_a", 520.0, 560.0, device=True, id=9),
        _ev("Memcpy DtoH (Device -> Pinned)", 620.0, 700.0, device=True, id=11,
            meta='"bytes": 800000'),
        _ev("oceanbench.render", 90.0, 420.0, device=True, id=7),   # the span's shadow
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((300 + 40 + 80) * 1e-6)
    assert s["device_ops"][0] == ["k_a", pytest.approx(240e-6)]
    assert s["spans"]["oceanbench.render"] == {"count": 2, "kernels": 3,
                                                "device_ms": pytest.approx(0.39)}
    assert s["dtoh"] == {"count": 1, "device_s": pytest.approx(80e-6), "bytes": 800000}
    longest, seconds = s["idle_gaps"][0]
    assert seconds == pytest.approx(300e-6) and longest == "aten::copy_"
    assert s["idle_gaps"][1] == ["host between calls", pytest.approx(120e-6)]


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "godotoceanwaves_tpu_torch": 1,
            "godotoceanwaves_tpu_torch.ops": 1, "flaxen": 1, "godotoceanwaves_tpu.ops": 1}
    assert harness.forbidden_modules(mods) == ["godotoceanwaves_tpu.ops", "jax", "jax.numpy"]


def test_a_judge_that_loads_jax_leaves_no_result(tmp_path, monkeypatch, capsys):
    root = tiny.tiny_copy(tmp_path)
    cell = manifest.find_cell("scene_1024.sim", root=root)
    judge = cell.driver.Driver.judge

    def judge_loading_jax(self, control=False):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return judge(self, control=control)

    monkeypatch.setattr(cell.driver.Driver, "judge", judge_loading_jax)
    monkeypatch.setattr(harness.manifest, "find_cell", lambda name: cell)
    run_cell = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda *a, **kw: run_cell(
        *a, **kw, device="cpu", check_card=False))
    tiny.torch.set_num_threads(1)
    rc = harness.main(["--workload", "scene_1024.sim", "--seed", str(tiny.SEED),
                       "--seconds", "0.4", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out.strip() == ""
    assert "'jax'" in out.err


def test_without_a_card_the_run_fails_and_prints_no_result():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(harness.NoCard):
        harness.require_card(torch, 1)
    proc = subprocess.run([sys.executable, "oceanbench/run.py", "--workload", "scene_1024.sim",
                           "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_correct_on_the_cpu_at_a_tiny_size(cell, tmp_path):
    root = tiny.tiny_copy(tmp_path)
    result = tiny.run(root, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    wl = json.loads((root / "oceanbench" / "workloads" / f"{cell}.json").read_text())
    assert list(result["checks"]) == list(wl["limits"])
    assert list(result)[-1] == "checks"


def test_the_peak_leaves_out_what_the_judge_holds():
    class Storage:
        def __init__(self, ptr, nbytes):
            self.ptr, self.n = ptr, nbytes

        def data_ptr(self):
            return self.ptr

        def nbytes(self):
            return self.n

    class Tensor:
        device = types.SimpleNamespace(type="cuda")

        def __init__(self, ptr, nbytes):
            self.storage = Storage(ptr, nbytes)

        def untyped_storage(self):
            return self.storage

    readings = iter([100, 130, 150, 180, 120])     # the allocator's peak at each close

    cuda = types.SimpleNamespace(max_memory_allocated=lambda device: next(readings),
                                 reset_peak_memory_stats=lambda device: None)
    fake = types.SimpleNamespace(Tensor=Tensor, cuda=cuda)
    rec = records.Records(cell=None, seed=0, seconds=1.0, torch=fake,
                          device=types.SimpleNamespace(type="cuda"))
    a, b = Tensor(1, 20), Tensor(2, 40)
    rec.hold(a, a, "not a tensor")      # closes 100 with nothing held; holds 20 once
    rec.hold(b, a)                      # closes 130 - 20; holds 60
    assert rec.peak_less_held() == 110  # 150 - 60 < 110
    rec.unhold(b)                       # closes 180 - 60 = 120; holds 20
    assert rec.peak_less_held() == 120  # 120 - 20 = 100 < 120
