"""`bench_torch.py`, the port's benchmark, on the CPU at toy sizes.

Each leg function runs with device="cpu" (the kernels' plain versions, the
host clock); the record's fields, the exit codes and the failed-leg report
are checked through `report` with the legs' CPU results. The CLI itself
needs a card: without one it exits non-zero and prints no record. The
`--rms` leg is held to its gate, 1e-4 relative RMS against tests/oracle.py,
and config 4's checksum to the JAX package's multi-frame step on the same
inputs (1e-4 relative, the JAX fused kernel in interpret mode).
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.models import multi_step as jmulti_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
# the record: bench.py's keys, then the port's baseline_ms, baseline and card
RECORD_KEYS = (
    "metric", "value", "unit", "vs_baseline", "p99_ms", "min_ms", "rms_vs_oracle", "rms_tier",
    "config5_ms_frame", "config5_stream_fps", "config5_stream_MBps",
    "config5_stream_bytes_frame", "config5_preview_fps", "config5_fft", "render_ms_frame",
    "render_720p_scale2_ms", "render_720p_native_ms", "baseline_ms", "baseline", "card")


def config4_cpu():
    return bench_torch.bench_config4(device="cpu", map_size=64, k=4, frames=8, reps=3,
                                     baseline_k=2, baseline_reps=1)


def cpu_legs():
    return {"--rms": bench_torch.bench_rms(device="cpu", map_size=64),
            "--config5": bench_torch.bench_config5(device="cpu", map_size=64, frames=4,
                                                   n_stream=3),
            "--render": bench_torch.bench_render(device="cpu", map_size=64, width=64,
                                                 height=36, warmup=1, blocks=1, frames=1)}


def records(out: str) -> list:
    return [json.loads(line) for line in out.strip().splitlines()]


def test_config4_leg_on_cpu():
    r = config4_cpu()
    assert r["min"] <= r["p50"] <= r["p99"] <= r["max"]
    assert r["host"]["min"] <= r["host"]["p50"] <= r["host"]["p99"] <= r["host"]["max"]
    assert r["clock"] == "host clock" and r["peak_GiB"] is None
    assert np.isfinite(r["checksum"]) and r["baseline_ms"] > 0
    assert r["config"].step_tier() == "fused" and (r["k"], r["frames"], r["reps"]) == (4, 8, 3)


def test_config4_checksum_matches_jax_multi_step(monkeypatch):
    """The leg's 4 cascades at 128^2 (the JAX fused kernel's smallest bf16
    size), its warm-up call and 3 blocks of 8 frames at K = 4, against the
    JAX package's multi_step over the same frames on its fused kernel
    (interpret mode), which shares the multi-frame time semantics."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    r = bench_torch.bench_config4(device="cpu", map_size=128, k=4, frames=8, reps=3,
                                  baseline_k=2, baseline_reps=1)
    four = jax.tree.map(lambda x: jnp.concatenate([x, x[:1]]), J.default_cascades())
    cfg = J.SimConfig(map_size=128, map_dtype="bfloat16", fft_impl="pallas")
    assert cfg.use_fused_step()
    state = J.init_state(cfg, four)
    for _ in range(1 + 3 * 2):
        state, maps = jmulti_step(cfg, state, four, np.float32(0.02), 4)
    want = float(np.asarray(state.foam)[:, 0, :].sum()
                 + np.asarray(maps.displacement[:, :, 0, :], np.float32).sum())
    assert abs(r["checksum"] - want) <= 1e-4 * abs(want)


def test_rms_leg_on_cpu_is_within_the_gate():
    r = bench_torch.bench_rms(device="cpu", map_size=64)
    assert r["tier"] == "fused"
    assert r["rms"] <= bench_torch.RMS_GATE


def test_config5_leg_on_cpu():
    r = bench_torch.bench_config5(device="cpu", map_size=64, frames=4, n_stream=3)
    assert r["fft"] == "fused" and r["ms_frame"] > 0 and r["host_ms_frame"] > 0
    assert r["stream_bytes_frame"] == 2 * 7 * 64 * 64 * 4          # fp32 host arrays
    assert r["preview_bytes_frame"] == 2 * 7 * 32 * 32 * 4
    assert r["stream_fps"] > 0 and r["preview_fps"] > 0
    assert r["stream_MBps"] == round(r["stream_fps"] * r["stream_bytes_frame"] / 1e6, 3)


def test_render_leg_on_cpu():
    r = bench_torch.bench_render(device="cpu", map_size=64, width=64, height=36, warmup=1,
                                 blocks=2, frames=1)
    legs = ("ms_frame", "ms_frame_720p_scale2", "ms_frame_720p_native")
    assert set(r) == {*legs, *(f"host_{k}" for k in legs)}
    assert all(r[k] > 0 for k in r)


def test_render_leg_times_one_graphed_program_a_frame(monkeypatch):
    """Each render leg's frame is one `graphs.graphed` program (the render
    and the sum of its pixels, bench.py's jitted `frame(eps)`), called once
    a frame with the carry, and returning a 0-d tensor."""
    from godotoceanwaves_tpu_torch.utils import graphs
    programs = []
    real = graphs.graphed

    def spy(fn, pool=None):
        g = real(fn, pool)
        calls = []
        programs.append(calls)

        def call(*args):
            calls.append(args)
            out = g(*args)
            assert isinstance(out, torch.Tensor) and out.ndim == 0
            return out
        return call

    monkeypatch.setattr(graphs, "graphed", spy)
    bench_torch.bench_render(device="cpu", map_size=32, width=32, height=18, warmup=1,
                             blocks=2, frames=2)
    assert [len(c) for c in programs] == [1 + 2 * 2] * 3
    assert all(len(args) == 1 and args[0].ndim == 0 for c in programs for args in c)


def test_record_holds_exactly_the_listed_keys_and_grows_by_superset(capsys):
    legs = cpu_legs()
    rc = bench_torch.report(config4_cpu(), "test card, 700.00 W", lambda flag: legs[flag])
    out = records(capsys.readouterr().out)
    assert rc == 0 and len(out) == 4
    assert sorted(out[-1]) == sorted(RECORD_KEYS)
    for before, after in zip(out, out[1:]):
        assert before.items() <= after.items()
    last = out[-1]
    assert last["card"] == "test card, 700.00 W" and last["unit"] == "ms/frame"
    assert last["vs_baseline"] == pytest.approx(last["baseline_ms"] / last["value"], rel=1e-3)
    assert last["rms_tier"] == "fused" and last["config5_fft"] == "fused"
    assert last["rms_vs_oracle"] <= bench_torch.RMS_GATE


def test_failed_leg_exits_non_zero_and_the_other_legs_still_print(capsys):
    legs = cpu_legs()

    def run_leg(flag):
        if flag == "--config5":
            raise bench_torch.LegFailed("--config5 exited 1; stderr tail:\nRuntimeError: boom")
        return legs[flag]

    rc = bench_torch.report(config4_cpu(), "test card", run_leg)
    captured = capsys.readouterr()
    out = records(captured.out)
    assert rc != 0
    assert "rms_vs_oracle" in out[-1] and "render_ms_frame" in out[-1]
    assert not any(k.startswith("config5_") for k in out[-1])
    assert "failed legs: --config5" in captured.err and "boom" in captured.err


def test_cli_without_a_card_exits_non_zero_and_prints_no_record():
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], capture_output=True,
                          text=True, timeout=120, env=NO_CARD, cwd=str(ROOT))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs a CUDA device" in proc.stderr


def test_a_leg_process_that_fails_raises_with_its_stderr_tail(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(bench_torch.LegFailed, match="needs a CUDA device"):
        bench_torch._leg_subprocess("--rms", timeout=120)


def test_usage_and_watchdog():
    assert bench_torch.main(["--bogus"]) == 2
    assert bench_torch.main(["--rms", "--render"]) == 2
    code = "import time, bench_torch; bench_torch._init_watchdog(0.2); time.sleep(30)"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, env=NO_CARD, cwd=str(ROOT))
    assert proc.returncode == 3 and "watchdog" in proc.stderr
