"""Benchmark of the PyTorch port on one CUDA card: `bench.py`'s legs and record.

    python3 bench_torch.py              # every leg; one JSON record a finished leg
    python3 bench_torch.py --rms        # one leg alone, its own JSON line
    python3 bench_torch.py --config5
    python3 bench_torch.py --render

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and the CUDA toolkit; the first launch builds the kernels with nvcc
(`godotoceanwaves_tpu_torch/ops/_build.py`). The counterpart of `bench.py`,
with its shapes:

- Config 4 (in this process): 4 cascades (the demo scene's three and
  cascade 0 again) at 1024^2, bf16 maps, dt 0.02, stepped by `multi_step`
  48 frames a call (the K1 kernel pair, 2 launches a frame), 10 blocks of
  960 frames. Each block is timed with CUDA events from before its first
  call to after its checksum's reduction, the host clock beside; the
  checksum is fetched at the end of every block, so each block chains on
  the last. `value` is the p50 ms/frame. `vs_baseline` divides the plain
  PyTorch step (`fused_step.fused_cascade_multi_step_reference`: modulate ->
  torch.fft -> unpack), timed from the same state in the same run, by it.
- `--rms`: one 512^2 fp32 `step` of the demo scene's cascades (K1) against
  the NumPy transcription of the reference shaders (`tests/oracle.py`):
  the larger relative RMS of displacement and normal; gate 1e-4.
- `--config5`: the dual wind + swell cascades at 2048^2, bf16 maps (K4),
  48 timed `step`s, then 24 frames streamed to host memory through
  `MapStreamer` at full resolution and 24 in the preview tier.
- `--render`: `Ocean(map_size=1024, map_dtype="bfloat16")` with the demo
  scene's cascades, rendered at 640x360, at 1280x720 with render_scale=2
  and at native 1280x720 (interactive tier, environment on; one K5 launch
  a frame, no K6): 2 warm-up frames, then the best of 3 x 12 frames by
  CUDA events, frames chained through a bounded camera nudge. Each frame
  (the render and the sum of its pixels) is one captured CUDA graph
  (`utils/graphs.py`), replayed once a frame, as `bench.py` times one
  jitted program a frame; the first warm-up frame captures it.

The record is printed after config 4 and again, as a superset, after each
later leg, so the last line holds every field. Each later leg runs in a
fresh process of this script (its own allocator state and peak). A leg
that fails prints its error; the others still run, and the script then
exits non-zero and names the failed legs. Without a CUDA device it exits
non-zero before printing any record. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
from typing import Callable

import numpy as np
import torch

from godotoceanwaves_tpu_torch import SimConfig, default_cascades, init_state
from godotoceanwaves_tpu_torch.models.cascade import CascadeParams, dual_wind_swell_cascades
from godotoceanwaves_tpu_torch.models.ocean import _foam_rates, multi_step, step
from godotoceanwaves_tpu_torch.ops import fused_step, march, strip_step, tap
from godotoceanwaves_tpu_torch.utils import graphs

K = 48         # frames a multi_step call
FRAMES = 960   # frames a timing block
REPS = 10      # timing blocks: p50 is the value
BASELINE_K, BASELINE_REPS = 8, 3    # the plain step: ~2.25 ms a frame at config 4
STREAM_FRAMES = 24                  # config 5's streamed frames a tier
RMS_GATE = 1e-4                     # relative RMS vs tests/oracle.py
LEG_TIMEOUT = 900.0                 # s for one leg's process
WATCHDOG_S = 1800.0                 # s for config 4, the first nvcc build included
RENDER_TIER = dict(quality="high", march_steps=32, bisect_steps=6, shade_res=2,
                   bracket_res=128, invert_res=256, environment=True, sampler="mxu")


class LegFailed(RuntimeError):
    """A leg raised, or its process exited non-zero."""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_torch.py needs a CUDA device and none is available; "
                           "the leg functions take device='cpu' for a run on the CPU")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Window:
    """Elapsed ms of one timed window: CUDA events on the card with the host
    clock beside; the host clock alone on the CPU (no events there)."""

    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"

    def __enter__(self) -> "Window":
        if self.on_card:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def mark(self) -> None:
        """The window's device end: after the last work it times was enqueued."""
        if self.on_card:
            self._end.record()

    def __exit__(self, *exc) -> None:
        if self.on_card:
            self._end.synchronize()
        self.host_ms = (time.perf_counter() - self._t0) * 1e3
        self.ms = self._start.elapsed_time(self._end) if self.on_card else self.host_ms


def percentiles(times: list) -> dict:
    """p50, p99, min and max with bench.py's index formulas."""
    t = sorted(times)
    return {"p50": t[len(t) // 2], "p99": t[min(len(t) - 1, round(0.99 * (len(t) - 1)))],
            "min": t[0], "max": t[-1]}


def check_launches(on_card: bool, module, before: int, expected: int, what: str) -> None:
    """On the card, `module`'s kernel launched `expected` times since `before`.
    On the CPU the wrappers run their plain versions and count nothing."""
    if on_card and module.LAUNCHES - before != expected:
        raise RuntimeError(f"{what}: expected {expected} launches of {module.__name__}, "
                           f"counted {module.LAUNCHES - before}")


def four_cascades(device="cuda") -> CascadeParams:
    """Config 4's cascades: the demo scene's three, then cascade 0 again."""
    return default_cascades(device=device).map(lambda x: torch.cat([x, x[:1]]))


def checksum(state, maps) -> torch.Tensor:
    return state.foam[:, 0, :].sum() + maps.displacement[:, :, 0, :].float().sum()


def bench_config4(device="cuda", map_size: int = 1024, k: int = K, frames: int = FRAMES,
                  reps: int = REPS, baseline_k: int = BASELINE_K,
                  baseline_reps: int = BASELINE_REPS) -> dict:
    """Config 4: ms/frame of `multi_step` blocks, and the plain step beside it."""
    if frames % k:
        raise ValueError(f"frames ({frames}) must be a multiple of k ({k})")
    device = torch.device(device)
    on_card = device.type == "cuda"
    config = SimConfig(map_size=map_size, map_dtype="bfloat16")
    params = four_cascades(device)
    state = init_state(config, params)
    dt = 0.02
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    # warm-up outside the timed blocks: the first call builds the kernels
    state, maps = multi_step(config, state, params, dt, k)
    checksum(state, maps).item()
    if on_card:
        torch.cuda.synchronize(device)

    times, host_times, value = [], [], 0.0
    for _ in range(reps):
        before = fused_step.LAUNCHES
        with Window(device) as w:
            for _ in range(frames // k):
                state, maps = multi_step(config, state, params, dt, k)
            total = checksum(state, maps)
            w.mark()
            value = total.item()
        check_launches(on_card, fused_step, before, 2 * frames, "config 4 block")
        times.append(w.ms / frames)
        host_times.append(w.host_ms / frames)
    if not np.isfinite(value):
        raise RuntimeError(f"config 4 checksum is not finite: {value}")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if on_card else None
    del maps

    # the yardstick: the plain PyTorch step from the same state, called directly
    grow, decay = _foam_rates(params, dt)
    base_times = []
    for _ in range(baseline_reps):
        with Window(device) as w:
            scal = fused_step.pack_scalars(state.time + dt, params.tile_length,
                                           params.whitecap, grow, decay, dt=dt)
            disp, _, foam = fused_step.fused_cascade_multi_step_reference(
                state.h0, state.h0nc, state.omega, state.foam, scal,
                num_frames=baseline_k, map_dtype=config.resolved_map_dtype())
            state = state.replace(foam=foam, time=state.time + dt * baseline_k)
            total = foam[:, 0, :].sum() + disp[:, -1, :, 0, :].float().sum()
            w.mark()
            total.item()
        base_times.append(w.ms / baseline_k)
    return {**percentiles(times), "blocks": times, "host": percentiles(host_times),
            "checksum": value,
            "peak_GiB": peak, "baseline_ms": percentiles(base_times)["p50"],
            "config": config, "k": k, "frames": frames, "reps": reps, "clock": (
                "CUDA events" if on_card else "host clock")}


def bench_rms(device="cuda", map_size: int = 512) -> dict:
    """One fp32 step of the demo scene's cascades against tests/oracle.py's
    staged chain for cascade 0 (bench.py:120-170): the larger relative RMS
    of displacement and normal, and the step's tier."""
    tests = str(pathlib.Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import oracle

    device = torch.device(device)
    n, dt = map_size, 0.1
    cfg = SimConfig(map_size=n, map_dtype="float32")
    params = default_cascades(device=device)
    state = init_state(cfg, params)
    before = fused_step.LAUNCHES
    _, maps = step(cfg, state, params, dt)
    check_launches(device.type == "cuda", fused_step, before, 2, "--rms step")
    got_d = maps.displacement[0].cpu().numpy().transpose(1, 2, 0)
    got_n = maps.normal[0].cpu().numpy().transpose(1, 2, 0)

    p0 = params.map(lambda x: x[0].cpu())
    u, f_m = float(p0.wind_speed), float(p0.fetch_length) * 1e3
    tile = tuple(float(v) for v in p0.tile_length)
    h0, h0nc = oracle.packed_spectrum(
        n, tuple(int(v) for v in p0.spectrum_seed), tile,
        alpha=float(oracle.jonswap_alpha(u, f_m)),
        w_p=float(oracle.jonswap_peak_angular_frequency(u, f_m)),
        wind_speed=u, angle=np.deg2rad(float(p0.wind_direction)).astype(np.float32),
        depth=cfg.depth, swell=float(p0.swell), detail=float(p0.detail),
        spread=float(p0.spread))
    layers = oracle.modulate(h0, h0nc, tile, cfg.depth, 120.0 + dt)
    out = oracle.reference_fft_chain(layers, oracle.butterfly_factors(n))
    grow = dt * float(p0.foam_amount) * 7.5
    decay = dt * max(0.5, 10.0 - float(p0.foam_amount)) * 1.15
    ref_d, ref_n, _ = oracle.unpack(out, np.zeros((n, n), np.float32),
                                    float(p0.whitecap), grow, decay)

    def rel_rms(got, ref):
        scale = max(1e-9, float(np.sqrt(np.mean(ref.astype(np.float64) ** 2))))
        d = got.astype(np.float64) - ref.astype(np.float64)
        return float(np.sqrt(np.mean(d * d))) / scale

    return {"rms": max(rel_rms(got_d, ref_d), rel_rms(got_n, ref_n)), "tier": cfg.step_tier()}


def bench_config5(device="cuda", map_size: int = 2048, frames: int = 48,
                  n_stream: int = STREAM_FRAMES) -> dict:
    """Config 5: ms/frame of `step` (K4 at 2048^2), then frames/s streamed to
    host memory at full resolution and in the preview tier."""
    from godotoceanwaves_tpu_torch.utils.streaming import MapStreamer, preview_maps

    device = torch.device(device)
    on_card = device.type == "cuda"
    config = SimConfig(map_size=map_size, map_dtype="bfloat16")
    params = dual_wind_swell_cascades(device=device)
    state = init_state(config, params)
    dt = 0.02
    state, maps = step(config, state, params, dt)
    checksum(state, maps).item()

    before = strip_step.LAUNCHES
    with Window(device) as w:
        for _ in range(frames):
            state, maps = step(config, state, params, dt)
        total = checksum(state, maps)
        w.mark()
        value = total.item()
    check_launches(on_card, strip_step, before, 2 * frames, "config 5 steps")
    if not np.isfinite(value):
        raise RuntimeError(f"config 5 checksum is not finite: {value}")

    def step_once():
        nonlocal state
        state, m = step(config, state, params, dt)
        return m

    def stream_rate(step_fn) -> tuple[float, int]:
        """Frames/s over n_stream frames after one untimed frame, and the
        host bytes of a frame."""
        streamer = MapStreamer(step_fn)
        for _ in streamer.stream(num_frames=1):
            pass
        nbytes = 0
        t0 = time.perf_counter()
        for host_maps in streamer.stream(num_frames=n_stream):
            nbytes = sum(int(v.nbytes) for v in host_maps.values())
        seconds = time.perf_counter() - t0
        streamer.close()
        return n_stream / seconds, nbytes

    before = strip_step.LAUNCHES
    stream_fps, bytes_frame = stream_rate(step_once)
    step_preview = lambda: preview_maps(step_once())
    m0 = step_preview()                       # the decimation chain, outside the window
    m0.displacement[:, :, 0, :].float().sum().item()
    preview_fps, pv_bytes = stream_rate(step_preview)
    check_launches(on_card, strip_step, before, 2 * (2 * (1 + n_stream) + 1), "config 5 streams")
    return {"ms_frame": w.ms / frames, "host_ms_frame": w.host_ms / frames,
            "stream_fps": stream_fps, "fft": config.step_tier(),
            "stream_bytes_frame": bytes_frame,
            "stream_MBps": round(stream_fps * bytes_frame / 1e6, 3),
            "preview_fps": round(preview_fps, 4), "preview_bytes_frame": pv_bytes}


def bench_render(device="cuda", map_size: int = 1024, width: int = 640, height: int = 360,
                 warmup: int = 2, blocks: int = 3, frames: int = 12) -> dict:
    """The three render legs: width x height, and twice that at render_scale=2
    and native. Best ms/frame of `blocks` x `frames` chained frames."""
    from godotoceanwaves_tpu_torch import Ocean
    from godotoceanwaves_tpu_torch.models.geometry import render_ocean_geometry

    device = torch.device(device)
    on_card = device.type == "cuda"
    ocean = Ocean(map_size=map_size, map_dtype="bfloat16", updates_per_second=0, device=device)
    maps = ocean.update(1 / 60)
    scales = ocean.params.map_scales()
    cam0 = torch.tensor([0.0, 12.0, 0.0], device=device)
    legs = {"ms_frame": dict(width=width, height=height),
            "ms_frame_720p_scale2": dict(width=2 * width, height=2 * height, render_scale=2),
            "ms_frame_720p_native": dict(width=2 * width, height=2 * height)}
    out = {}
    for name, size in legs.items():
        carry = [torch.zeros((), device=device)]

        def render_sum(eps, size=size):
            # each frame waits for the last; the pose moves by at most 1e-6 m
            img = render_ocean_geometry(maps, scales, camera_pos=cam0 + torch.tanh(eps) * 1e-6,
                                        **RENDER_TIER, **size)
            return img.sum()

        program = graphs.graphed(render_sum)    # bench.py's jax.jit(frame)

        def frame():
            carry[0] = program(carry[0])

        before = (tap.LAUNCHES, march.LAUNCHES)
        for _ in range(warmup):
            frame()
        carry[0].item()
        best, best_host = float("inf"), float("inf")
        for _ in range(blocks):
            with Window(device) as w:
                for _ in range(frames):
                    frame()
                w.mark()
                value = carry[0].item()
            best, best_host = min(best, w.ms / frames), min(best_host, w.host_ms / frames)
        if not np.isfinite(value):
            raise RuntimeError(f"render {name}: frame sum is not finite: {value}")
        rendered = warmup + blocks * frames
        check_launches(on_card, tap, before[0], rendered, f"render {name} (K5)")
        check_launches(on_card, march, before[1], 0, f"render {name} (K6)")
        out[name], out[f"host_{name}"] = best, best_host
    return out


def _leg_subprocess(flag: str, timeout: float = LEG_TIMEOUT) -> dict:
    """One leg in a fresh process of this script: its JSON line, or LegFailed
    with the end of its stderr."""
    try:
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), flag],
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        tail = (e.stderr or b"")[-4000:]
        raise LegFailed(f"{flag} timed out after {timeout:.0f} s; stderr tail:\n"
                        f"{tail.decode(errors='replace') if isinstance(tail, bytes) else tail}")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise LegFailed(f"{flag} exited {proc.returncode}; stderr tail:\n{proc.stderr[-4000:]}")
    sys.stderr.write(proc.stderr)
    return json.loads(lines[-1])


def report(r4: dict, card: str, run_leg: Callable[[str], dict] = _leg_subprocess) -> int:
    """Print config 4's record, then run the later legs through `run_leg`
    and re-print the record as each finishes. Returns the exit code: 0 when
    every leg finished, 1 when any failed."""
    config = r4["config"]
    peak = "not measured" if r4["peak_GiB"] is None else f"{r4['peak_GiB']:.3f} GiB"
    log(f"config4: tier={config.step_tier()} K={r4['k']} frames={r4['frames']}x{r4['reps']} "
        f"({r4['clock']}) p50={r4['p50']:.4f}ms p99={r4['p99']:.4f}ms min={r4['min']:.4f}ms "
        f"max={r4['max']:.4f}ms (blocks in order {[round(t, 4) for t in r4['blocks']]}); "
        f"host clock p50={r4['host']['p50']:.4f}ms; "
        f"plain step {r4['baseline_ms']:.4f}ms; peak {peak}; "
        f"checksum={r4['checksum']:.4e}; card {card}")
    record = {
        "metric": "4-cascade 1024^2 spectrum+IFFT+maps update (bf16 maps, fp32 FFT core)",
        "value": round(r4["p50"], 4),
        "unit": "ms/frame",
        "vs_baseline": round(r4["baseline_ms"] / r4["p50"], 4),
        "baseline_ms": round(r4["baseline_ms"], 4),
        "baseline": "plain PyTorch step (fused_cascade_multi_step_reference: modulate -> "
                    "torch.fft -> unpack) ms/frame, same card and state, divided by value",
        "p99_ms": round(r4["p99"], 4),
        "min_ms": round(r4["min"], 4),
        "card": card,
    }
    print(json.dumps(record), flush=True)
    failed = []

    def leg(flag: str, fields: Callable[[dict], dict], summary: Callable[[dict], str]):
        nonlocal record
        try:
            res = run_leg(flag)
        except Exception as e:  # a failed leg is reported; the others still run
            log(f"{flag} leg failed: {e}")
            failed.append(flag)
            return
        log(summary(res))
        record = {**record, **fields(res)}
        print(json.dumps(record), flush=True)

    leg("--rms", lambda r: {"rms_vs_oracle": r["rms"], "rms_tier": r["tier"]},
        lambda r: f"rms: 512^2 fp32 step ({r['tier']} tier) vs tests/oracle.py = "
                  f"{r['rms']:.3e} relative RMS (gate {RMS_GATE:g})")
    leg("--config5", lambda r: {
            "config5_ms_frame": round(r["ms_frame"], 4),
            "config5_stream_fps": round(r["stream_fps"], 4),
            "config5_stream_MBps": r["stream_MBps"],
            "config5_stream_bytes_frame": r["stream_bytes_frame"],
            "config5_preview_fps": r["preview_fps"],
            "config5_fft": r["fft"]},
        lambda r: f"config5: 2048^2 dual spectra ({r['fft']} tier) {r['ms_frame']:.4f} ms/frame "
                  f"(host clock {r['host_ms_frame']:.4f}); streamed to host "
                  f"{r['stream_fps']:.2f} frames/s ({r['stream_MBps']:.1f} MB/s at "
                  f"{r['stream_bytes_frame']} B/frame); preview {r['preview_fps']:.2f} frames/s "
                  f"at {r['preview_bytes_frame']} B/frame")
    leg("--render", lambda r: {
            "render_ms_frame": round(r["ms_frame"], 4),
            "render_720p_scale2_ms": round(r["ms_frame_720p_scale2"], 4),
            "render_720p_native_ms": round(r["ms_frame_720p_native"], 4)},
        lambda r: f"render: 640x360 {r['ms_frame']:.3f} ms/frame (host clock "
                  f"{r['host_ms_frame']:.3f}); 1280x720 render_scale=2 "
                  f"{r['ms_frame_720p_scale2']:.3f} ({r['host_ms_frame_720p_scale2']:.3f}); "
                  f"native 1280x720 {r['ms_frame_720p_native']:.3f} "
                  f"({r['host_ms_frame_720p_native']:.3f})")
    if failed:
        log(f"bench_torch: failed legs: {' '.join(failed)}")
        return 1
    return 0


def _init_watchdog(seconds: float = WATCHDOG_S) -> threading.Event:
    """Exit with code 3 if config 4 has not finished within `seconds`: its
    first call builds the kernels with nvcc and launches them, and a build
    or launch that hangs must fail an unattended run, not stall it."""
    done = threading.Event()

    def fire():
        if not done.wait(seconds):
            log(f"bench watchdog: no config-4 result within {seconds:.0f} s (the kernels' "
                "first nvcc build or launch hung); aborting")
            os._exit(3)

    threading.Thread(target=fire, daemon=True).start()
    return done


LEGS = {"--rms": bench_rms, "--config5": bench_config5, "--render": bench_render}


def main(argv: list) -> int:
    if len(argv) > 1 or (argv and argv[0] not in LEGS):
        log(f"usage: {sys.argv[0]} [{' | '.join(LEGS)}]")
        return 2
    require_card()
    if argv:
        res = LEGS[argv[0]]()
        print(json.dumps(res), flush=True)
        if argv[0] == "--rms" and not res["rms"] <= RMS_GATE:
            log(f"--rms: relative RMS {res['rms']:.3e} is above the gate {RMS_GATE:g}")
            return 1
        return 0
    done = _init_watchdog()
    r4 = bench_config4()
    done.set()
    return report(r4, card_line())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
