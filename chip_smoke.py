#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, each of which raises on failure:

1. Toolchain: CUDA version, nvcc, card name and power limit; builds
   `godotoceanwaves_tpu_torch/csrc/*.cu` with nvcc (one process per source,
   in parallel) and prints the build time, the ptxas lines, and the
   registers, stack and spills of each instantiation of the step passes
   (K1's lengths and K4's splits).
2. The fused-step kernel pair (K1) against its plain PyTorch version,
   single frame and K=3 frames, at N = 128 and 1024, 3 cascades, seeded
   foam; one fp32 step at each other power of two from 16 to 512.
3. Parity with the NumPy transcription of the reference shaders
   (tests/oracle.py): one 512^2 step of cascade 0, fp32 maps, via K1.
4. Config 4: `Ocean.update` x 60 and `multi_step(..., 8)` at 4 cascades x
   1024^2 with bf16 maps (K1); launch counts, finiteness, foam range, height
   statistics, and agreement with the same run on the staged path, whose FFT
   is the planes kernel (K2).
5. Timing with CUDA events: K1 vs plain ms/frame at config 4; K1's row
   pass and column pass alone through the library calls (TB/s each); the
   pair's TB/s over the bytes it moves (its function's and the scratch's
   round trip) and its share of the bound; K2 at 16 x 1024^2 (K1's FFT
   alone, on the same core) timed in the same phase as the yardstick.
6. The strip-step kernel pair (K4) against its plain version: N = 2048 with
   config 5's 2 cascades, every map dtype, 1 frame and 3 frames through
   `multi_step`, seeded foam; N = 4096 and 8192 with 1 cascade, fp32 and bf16.
7. The planes IFFT kernel pair (K2: the rows DFT kernel storing 32-byte
   column records, then the column pass) against `fft.ifft2_packed_planes`
   (torch.fft): N = 16, 1024, 2048 and 8192, L = 8, both fold_sign values.
8. Config 5: `Ocean.update` x 48 at 2 cascades x 2048^2 with bf16 maps (K4),
   the same run with fused="never" (K2), compared; then `MapStreamer`'s
   full-resolution, native-dtype and preview legs.
9. Timing with CUDA events: K4 vs plain ms/frame at config 5; its row and
   column passes alone through the library calls, the pair's TB/s over the
   bytes it moves (its function's and the scratch's round trip) and its
   share of the bound, and K2 at 8 x 2048^2 (the same planes) timed in the
   same phase as the yardstick; K4 at 4096^2 and 8192^2 with 1 cascade
   (the split) and each pass alone; the staged step (fused="never", K2) at
   config 5; K2 vs torch.fft at 16 x 1024^2 and 8 x 2048^2 (TB/s, share of
   the bound, ratio to torch.fft.ifft2).
10. The LOD gradient-tap kernel (K5) against its plain version (the einsum
    taps): a random case (3 cascades at 1024^2, 4 levels, 16 bands whose
    levels hold 0, the bicubic-blending coarse level and the skip value),
    the gradient of a real 640x360 frame (`_debug_stage="grad"`), and the
    arguments `gradient_lod_tap` receives in one 1280x720 native frame
    (taken by a one-call wrapper around it).
11. The heightfield-march kernel (K6) against its plain version: a G = 256
    table from real maps and 640x360 and 1280x720 rays, 32 steps and 2
    refine rounds.
12. The render path at bench.py's render settings: `Ocean(map_size=1024,
    map_dtype="bfloat16")` with 3 default cascades, the "interactive" tier,
    environment on, and the three legs 640x360, 1280x720 at render_scale=2
    and 1280x720 native. Launch counts (one K5 launch a frame, no K6 on the
    default fan march; one march_impl="pallas" frame launches K6), images
    finite in [0, 1] with a plausible sky share, kernel route vs plain
    route, one frame per leg under `torch.cuda.set_sync_debug_mode("error")`.
13. Render timing with CUDA events: ms/frame of the three legs, the
    `_debug_stage` split at 640x360 and 720p native, K6 vs the fan march,
    peak device memory.
14. The rows DFT kernel (K3) against its plain version: the config-5 shard
    (16, 2, 1024, 2048), the 1024^2 shard at rows = 8 (16, 2, 128, 1024),
    and N = 16, 256, 8192 with R = 37 tail rows, both fold_sign values.
15. The sharded path (`parallel/`), every mesh position on the card:
    config 4's shape (4 x 1024^2) on a (1, 8) mesh for 8 frames against the
    unsharded step (K1), fp32 maps; BASELINE config 5 at full width (8
    patches x 2 cascades at 2048^2, bf16 maps) on a (4, 2) mesh for 48
    updates: launch counts, finite maps, foam in [0, 1], per-patch height
    std, one fp32 frame of patch 0 against the single-patch step (K4),
    `gather_maps`, one frame under `set_sync_debug_mode("error")`; a
    checkpoint saved on (4, 2), restored on (2, 4) and continued one frame
    against the unbroken run; `render_geometry_sharded` of patch 0 at
    640x360 over 8 bands against the dense render (gather sampler, no LOD,
    per-pixel march), and at the interactive tier (finite, sky share).
16. Timing with CUDA events: K3 vs its plain version and `torch.fft.ifft`
    at the config-5 shard shape (TB/s, share of the bound, ratio); the sharded config-5 step in ms/frame with
    its K3 / exchange / modulate / unpack split, beside 8 single-patch K4
    steps; peak device memory of a sharded step.

17. K5 and K6 alone: kernel-only and every device operation of a call
    (torch.profiler), the whole wrapper call (CUDA events), 5 x 200 calls.
18. The reference scene's frame loop (`--scene` runs phases 1 and 18
    only): `Ocean(map_size=1024, map_dtype="bfloat16")` with the 3 default
    cascades, 30 warm-up updates, `SpraySession(32768)`, and 48 frames of
    update + spray advance + a 640x360 `SceneRenderer` frame (interactive
    tier, environment on) through `FramePipeline`: launch counts (K1 2 an
    update, K5 and the splat chain 1 a frame), the frames (uint8, sky share, animation), the
    visible particles; the splat with every particle visible on the card
    against the CPU; a checkpoint of `Ocean` and `SpraySession` at frame 24
    restored into fresh objects for 4 frames (spray bit-equal, maps close);
    `make_batched_step` (K = 4) over 8 frames against the sequential loop;
    the YUV420 wire at 1280x720; one frame under
    `set_sync_debug_mode("error")`; 3 `LiveViewer` frames; one
    `demo_torch.py --frames 3 --spray` run (the render, the spray advance
    and the K-frame step each replay a captured CUDA graph on the card,
    phase 22). Then, at 640x360 and 1280x720,
    CUDA events and the host clock for `update`, the spray advance, the
    render without and with spray, the splat alone (and its product in fp32
    and as a bf16 product with an fp32 output), the loop through
    `FramePipeline` and fetching after each render; launches a frame and
    the device's busy share (torch.profiler), peak device memory.
19. The browser viewer (`--web` runs phases 1 and 19 only):
    `WebViewer(Ocean(map_size=1024, map_dtype="bfloat16"), fps=240,
    width=640, height=360, spray=True)` over localhost, the port's
    counterpart of scripts/probe_webviewer.py: the first frames, `/` and
    `/frame.png`, K1 and K5 launched (lower bounds: the sim thread and the
    reconfiguration worker both count); served frames/s over 10 s windows
    of the standard-library PNG at the rgb and yuv420 wires, frame_batch 1
    and 4, and 1280x720 at render_scale=2, then of the encoder the viewer
    picks where it runs (JPEG where PIL writes it); `_frame_bytes` alone
    on a real frame of each, and the PNG's zlib levels and row filters;
    every panel edit read back from /state; map_size 1024 -> 512 -> 1024
    and render_tier interactive -> performance -> interactive while
    serving (frames during each swap, /state within 2 s, the swap within
    30 s); a checkpoint restored into a second viewer on a fresh Ocean
    (spray bit-equal, camera and clocks equal); `demo_torch.py --web
    --spray` served and stopped.
20. The multi-process form of `parallel/` (`--multihost` runs phases 1
    and 20 only), each leg in workers spawned by `parallel.launch`, so this
    process never joins a process group: (a) one NCCL worker holding
    config 5 at full width on `make_multihost_mesh(rows=2)` over 8
    positions of the card, 48 updates (K3 16 a frame), against one
    controller driving the same positions (bit-equal), `gather_maps`
    through NCCL, ms/frame in turns with one controller and its
    `record_function` split, a checkpoint saved on (4, 2) and restored on
    (2, 4) (one frame against the unbroken run) and on (8, 1) (K4); (b) two
    gloo workers sharing the card, every rows group pairing them, after a
    probe of gloo's `all_to_all_single` and `all_gather` on CUDA tensors:
    4 frames on CUDA positions at full width where gloo takes them (else
    CPU positions at 256^2), bit-equal to one controller, ms/frame of
    gloo's loopback; (c) `graft_entry_torch.dryrun_multichip(8)` (K3 against
    torch.fft on CPU positions), `examples/multichip_torch.py`, and
    `graft_entry_torch.entry()` (K1 once).
21. The port's benchmark (`--bench` runs phases 1 and 21 only):
    `python3 bench_torch.py` in a subprocess (config 4 in it, `--rms`,
    `--config5` and `--render` each in a process of its own; the render
    legs time one captured CUDA graph a frame), which must exit 0; its last
    line must hold every field of the record, the oracle RMS within 1e-4,
    the K1 and strip tiers, positive times, and (in the full run) config
    4's ms/frame within 0.5-2x of phase 5's K1 pair.
22. The captured frame programs (`utils/graphs.py`; `--graphs` runs phases
    1 and 22 only) against the same programs run eagerly inside
    `graphs.disabled()`, on phase 18's scene (3 x 1024^2 bf16, 32768
    particles): the spray step through a restore and the ANSI field
    bit-equal; at 640x360, 1280x720 and 1280x720 at render_scale=2, frames
    with and without spray at a pose and colours that change a frame,
    bit-equal with one K5 launch a frame either way (and one splat chain
    with spray), the capture time, the renderer's pool bytes, the splat
    alone, its kernel against the plain route (max abs <= 1e-4, device time
    of each, in turns), the render and the loop through `FramePipeline`
    in turns (events and host clock), the device's busy share
    (torch.profiler) and one replayed frame under
    `set_sync_debug_mode("error")`; `make_batched_step` (K = 4, spray)
    twice, bit-equal, K1 2, K5 1 and the splat chain 1 a tick, ms a frame; phase 13's render
    legs as one graphed program a frame (the render and its sum) against
    the eager frame, chained, in turns.
23. The fan march's bracket select (`ops/fan.py`, `csrc/fan.cu`; `--fan`
    runs phases 1 and 23 only) on the arguments of one interactive-tier
    frame of real maps (3 x 1024^2 bf16) at 1280x720 and 640x360: the
    kernel's tsel, found, t_lo and t_hi against the plain chain's, bit for
    bit; each timed in CUDA events (3 blocks of calls a turn, kernel, plain,
    plain, kernel: the median block) and its device ms a call
    (torch.profiler, medians of 3 blocks), beside the bound of the
    compares this frame's walks make and of the worst case (every pixel
    over the whole table).
24. The spray step (`ops/spray.py`, `csrc/spray.cu`; `--spray` runs
    phases 1 and 24 only) at the frame cell's sizes: phase 18's scene (3 x
    1024^2 bf16), 32768 particles advanced 90 times at dt 1/60, then 8
    chained advances on each route, the kernel's state and attributes
    against `spray_step_plain`'s bit for bit; each route timed as phase 23
    times the fan, beside the bound of the bytes a step must move (the
    state in and out, the attributes, every particle's taps).

Every kernel's entry in the kernels line has its bound: the larger of the
bytes its function must move (each input read once, each output written
once; for K5 the distinct texels its taps touch) over the card's memory
rate and the operations it does over the fp32 rate (HBM_TBPS,
FP32_TFLOPS), from this run's inputs. K5's and K6's entries carry the
kernel-only `ms` and the whole wrapper call `call_ms` (phase 17). Prints a JSON line of
the sharded step, a JSON line of the scene loop, a JSON line of the browser
viewer, a JSON line of the multi-process legs, a JSON line of the benchmark's
record, a JSON line of the captured frame programs, a JSON line each of the
fan select and the spray step, the card's name and power limit, a JSON line
of the kernels, then as its last line
{"ok": true, "device": {...}}. Exits
non-zero, with no result line, when no CUDA device is present or any phase
fails. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "godotoceanwaves_tpu_torch/csrc/"
KERNELS = {
    "K1": dict(name="fused_step (rows + cols)", source=CSRC + "fused_step.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_step.py:328"),
    "K2": dict(name="planes_fft (rows_fft.cu row pass + planes_fft.cu column pass)",
               source=CSRC + "planes_fft.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_fft.py:345"),
    "K3": dict(name="rows_fft", source=CSRC + "rows_fft.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_fft.py:529"),
    "K4": dict(name="strip_step (rows + cols)", source=CSRC + "strip_step.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_strip.py:188"),
    "K5": dict(name="lod_tap", source=CSRC + "tap.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_tap.py:162"),
    "K6": dict(name="march_heightfield", source=CSRC + "march.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_march.py:152"),
}

# Tolerances. fp32 maps: the kernels and torch.fft differ only in summation
# order and twiddle rounding. 2-byte maps: one rounding of the fp32 fields can
# land on either side of a bf16/f16 step (the class tests/test_pallas_step.py
# and tests/test_pallas_strip.py use for 2-byte maps).
TOL_F32 = 1e-4          # relative RMS, displacement and normal; K2's planes
TOL_FOAM = 1e-4         # RMS, foam (fp32 either way)
TOL_2B_DISP = 1e-3      # relative RMS, displacement
TOL_2B_NORMAL = 2e-3    # RMS, normal
TOL_ORACLE = 1e-4       # relative RMS vs tests/oracle.py

KERNEL_SIZES = (128, 1024)   # phase 2, every dtype, 1 and 3 frames
SWEEP_SIZES = (16, 32, 64, 256, 512)   # phase 2, the rest of 16..1024, fp32
ORACLE_SIZE = 512            # phase 3 (bench.py's RMS leg)
MAIN_SIZE = 1024             # phases 4-5 (bench.py config 4)
STRIP_SIZE = 2048            # phases 6, 8-9 (bench.py config 5)
STRIP_BIG = (4096, 8192)     # phase 6, 1 cascade
PLANES_SIZES = (16, 1024, 2048, 8192)   # phase 7
PLANES_L = 8
CONFIG5_UPDATES = 48         # bench.py config 5's frame count
STREAM_FRAMES = 6
RENDER_MAP = 1024            # phases 10-13 (bench.py's render leg: 3 cascades, bf16)
# bench.py:284-315: the "interactive" tier (viewport.py:37-43), environment on
RENDER_TIER = dict(quality="high", march_steps=32, bisect_steps=6, shade_res=2,
                   bracket_res=128, invert_res=256, environment=True)
RENDER_LEGS = {"640x360": dict(width=640, height=360),
               "1280x720 render_scale=2": dict(width=1280, height=720, render_scale=2),
               "1280x720 native": dict(width=1280, height=720)}
CAM0 = (0.0, 12.0, 0.0)
TOL_TAP = 5e-5               # max abs, K5 vs plain (tests/test_pallas_tap.py:96-116)
TOL_FRAME = 1e-3             # mean |delta| of a frame, kernel vs plain route
MARCH_FOUND = 0.999          # K6 vs plain: share of pixels whose `found` agrees
TOL_MARCH = 1e-4             # K6 vs plain: relative lo/hi where both found
TAP_FRAME = "1280x720 native"             # phases 10, 17: K5 on the arguments of this leg's frame
MARCH_RAYS = ((640, 360), (1280, 720))    # phases 11, 17: K6's rays
MARCH_RUN = dict(march_steps=32, refine_rounds=2)   # the interactive tier's march
ALONE_CALLS, ALONE_REPEATS = 200, 5       # phase 17: back-to-back calls a repeat
# phase 18: the reference scene's frame loop (main.tscn: 3 default cascades,
# the 32768-particle spray), the viewers' interactive tier
SCENE = dict(map_size=1024, map_dtype="bfloat16", warmup=30, particles=32768, frames=48,
             checkpoint_at=24, resumed=4, batch=4, batch_frames=8, dt=1 / 30)
SCENE_SIZES = ((640, 360), (1280, 720))
SCENE_PITCH, SCENE_YAW = -12.0, 0.0
TOL_SPLAT = 2e-3             # max abs, splat on the card vs the CPU (2-byte class)
TOL_SPLAT_KERNEL = 1e-4      # max abs, the splat kernel vs the plain route on the card
TOL_BATCH_STEP, BATCH_EQUAL = 1, 0.999   # uint8 steps; share equal (tests/test_viewport.py:246-249)
TOL_YUV_MEAN = 6.0           # mean uint8 |delta| of the YUV420 round trip (tests/test_viewport.py:66)
SCENE_TIMING_ITERS = 10
# phase 19: the browser viewer on the card at scripts/probe_webviewer.py's
# settings, uncapped (fps 240): the scene's Ocean and spray, a 640x360
# interactive-tier frame; served frames/s over a WEB_WINDOW-second window
# of each WEB_RATES setting (tag, viewer arguments, frame_batch, encoder):
# the standard-library PNG forced ("png", what a machine without PIL
# serves) at each transfer, frame_batch and surface, then the encoder the
# viewer picks here ("auto": JPEG where PIL writes it)
WEB = dict(map_size=1024, map_dtype="bfloat16", fps=240.0, width=640, height=360,
           particles=32768, first_frames=5)
WEB_WINDOW = 10.0
WEB_720P = dict(width=1280, height=720, render_scale=2)
WEB_RATES = (("rgb png", dict(transfer="rgb"), 1, "png"),
             ("rgb png", dict(transfer="rgb"), 4, "png"),
             ("yuv420 png", dict(transfer="yuv420"), 1, "png"),
             ("yuv420 png", dict(transfer="yuv420"), 4, "png"),
             ("1280x720 render_scale=2 png", WEB_720P, 1, "png"),
             ("1280x720 render_scale=2 auto", WEB_720P, 1, "auto"),
             ("640x360 auto", dict(), 1, "auto"))
WEB_SWAP_LIMIT = 30.0        # s for a resize or tier switch to end
WEB_STATE_LIMIT = 2.0        # s for /state to answer while one runs
PNG_LEVELS, PNG_FILTERS, ENCODE_REPS = (0, 1, 3, 6, 9), (0, 2), 5
# phase 14: (L, R, N) of K3; the config-5 shard at rows = 2 comes first
ROWS_SHAPES = ((16, 1024, 2048), (16, 128, 1024), (4, 37, 16), (4, 37, 256), (4, 37, 8192))
SHARD_ROWS_MAIN = 8          # phase 15: config 4's shape on a (1, 8) mesh
SHARD_FRAMES = 8
SHARD_PATCHES = 8            # BASELINE config 5: 8 patches (BASELINE.json configs[4])
SHARD_ROWS_C5 = 2            # its (4, 2) mesh; the checkpoint restores on (2, 4)
SHARDED_SPANS = ("sharded/modulate", "sharded/rows_dft", "sharded/exchange", "sharded/unpack")
TOL_RESTORE_FOAM = 1e-5      # max abs (tests/test_multihost.py:59-63)
TOL_RESTORE_DISP = 1e-4
TOL_BANDS = 1e-4             # max abs, banded vs dense frame (tests/test_sharding.py:204)
# phase 20: the multi-process form of parallel/, each leg in spawned workers
MULTIHOST_GLOO_FRAMES = 4    # leg (b): ~1 GB crosses processes a frame through gloo
MULTIHOST_CPU_SIZE = 256     # leg (b) on CPU positions where gloo refuses CUDA tensors
MULTIHOST_TIMEOUT = 600.0    # s for a leg's workers and each collective
# phase 21: bench_torch.py's record (its fields, bench.py's and the port's own)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_ms", "baseline", "p99_ms",
              "min_ms", "rms_vs_oracle", "rms_tier", "config5_ms_frame", "config5_stream_fps",
              "config5_stream_MBps", "config5_stream_bytes_frame", "config5_preview_fps",
              "config5_fft", "render_ms_frame", "render_720p_scale2_ms",
              "render_720p_native_ms", "card")
BENCH_TIMEOUT = 900.0        # s for the whole bench, its legs' processes included
BENCH_VS_PHASE5 = (0.5, 2.0)  # config 4's value over phase 5's K1 pair ms/frame
# phase 22: the captured frame programs (utils/graphs.py) against the same
# programs run eagerly (graphs.disabled()): the scene of phase 18 at each
# GRAPH_SIZES (width, height, render_scale), and the render legs of phase 13
GRAPH_SIZES = ((640, 360, 1), (1280, 720, 1), (1280, 720, 2))
GRAPH_EQUAL_FRAMES = 3       # frames a size held bit-equal to eager, with and without spray
GRAPH_SPRAY_STEPS = 8        # spray advances each side of a restore
GRAPH_FIELD = (88.0, 96, 88)  # the ANSI field's (extent, cols, rows): LiveViewer's defaults
SPLAT_CALLS, SPLAT_REPEATS = 20, 3      # the splat leg's profiled blocks of calls
FAN_SIZES = ((1280, 720), (640, 360))   # phase 23: the frame cell's size and the web viewer's
FAN_CALLS, FAN_BLOCKS = 20, 3           # phase 23: CUDA-event blocks of back-to-back calls
# phase 24: the spray step at the frame cell's sizes (3 x 1024^2 bf16, 32768
# particles, dt 1/60), from the state after SPRAY_WARM advances
SPRAY_WARM, SPRAY_CHAIN, SPRAY_DT = 90, 8, 1 / 60
# The card's peaks (H100 SXM at 700 W: HBM3 rate and dense FP32 rate)
HBM_TBPS = 3.35
FP32_TFLOPS = 67.0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def _diff(got, ref):
    """(||got - ref||, ||ref||, max |got - ref|, count) where the tensors live;
    the difference in fp32, the norms accumulated in float64."""
    import torch
    got = torch.as_tensor(got).float()
    ref = torch.as_tensor(ref).to(got.device).float()
    d = got - ref
    norm = lambda x: float(torch.linalg.vector_norm(x, dtype=torch.float64))
    return norm(d), norm(ref), float(d.abs().max()), d.numel()


def rel_rms(got, ref) -> float:
    e, r, _, _ = _diff(got, ref)
    return e / max(r, 1e-300)


def rms(got, ref) -> float:
    e, _, _, count = _diff(got, ref)
    return e / count ** 0.5


def max_abs(got, ref) -> float:
    return _diff(got, ref)[2]


def host(t):
    return t.detach().float().cpu().numpy()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def launch_counts() -> dict:
    """The report's name of each op whose launches `_build.LAUNCHES` counts."""
    return {"K1": "fused_step", "K2": "planes_fft", "K3": "rows_fft", "K4": "strip_step",
            "K5": "tap", "K6": "march", "splat": "splat", "fan": "fan", "spray": "spray"}


def launches(op: str) -> int:
    """The launches of `op`'s kernels since the last `reset_counts`."""
    from godotoceanwaves_tpu_torch.ops import _build
    return _build.LAUNCHES[op]


def only(**launched) -> dict:
    """The launch counts of a run that launched `launched` and nothing else."""
    return {k: launched.get(k, 0) for k in launch_counts()}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fft_flops(n: int, transforms: int) -> float:
    """5 n log2 n flops per length-n complex transform."""
    return 5.0 * n * math.log2(n) * transforms


def bound(moved: float, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and flops over the fp32 rate."""
    t_bytes = moved / (HBM_TBPS * 1e9)
    t_ops = flops / (FP32_TFLOPS * 1e9)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_bound(args, outs, cascades: int, n: int) -> tuple[float, str]:
    """A whole step's bound (K1, K4): state in, maps and foam out; the
    operations of the 2D IFFT of 4 layers a cascade (modulate and unpack
    not counted)."""
    return bound(nbytes(*args, *outs), fft_flops(n, cascades * 4 * 2 * n))


def reset_counts() -> None:
    from godotoceanwaves_tpu_torch.ops import _build
    _build.LAUNCHES.clear()


def read_counts() -> dict:
    return {k: launches(op) for k, op in launch_counts().items()}


def phase_toolchain(torch, build) -> str:
    log(f"[1] torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    log(f"[1] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    path, nvcc_log = build.compile_library()
    log(f"[1] built {os.path.relpath(path, ROOT)} from {len(build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if any(key in line for key in ("entry function", "registers", "spill")):
            log(f"[1] ptxas: {line.strip()}")
    for name, (regs, stack, spills) in step_pass_registers(nvcc_log).items():
        log(f"[1] {name}: {regs} registers, {spills} bytes spilled, {stack} bytes stack")
    build.load()
    return card


def step_pass_registers(nvcc_log: str) -> dict:
    """ptxas's figures for each instantiation of the step passes
    (`csrc/step_passes.cuh`): {"K4 step_rows_kernel<11, 2>": (registers,
    stack bytes, spill store + load bytes)}; K1 runs split 1, K4 splits 2
    and 4."""
    import re
    dtypes = {"f": "float", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    out, name, stack, spills = {}, None, 0, 0
    for line in nvcc_log.splitlines():
        entry = re.search(r"Compiling entry function '\S*(step_(?:rows|cols)_kernel)ILi(\d+)ELi"
                          r"(\d+)E(?:Li\d+E)*(f|13__nv_bfloat16|6__half)?(?:Li\d+E)*E", line)
        if entry:
            kernel, log2m, split, dtype = entry.groups()
            args = [log2m, split] + ([dtypes[dtype]] if dtype else [])
            name = f"{'K4' if int(split) > 1 else 'K1'} {kernel}<{', '.join(args)}>"
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", line)
        if frame and name:
            stack, spills = int(frame.group(1)), int(frame.group(2)) + int(frame.group(3))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out[name] = (int(used.group(1)), stack, spills)
            name = None
    return out


def seeded_inputs(torch, T, n: int, dev, params=None):
    params = T.default_cascades(device=dev) if params is None else params
    state = T.init_state(T.SimConfig(map_size=n), params)
    rng = np.random.default_rng(n)
    c = params.num_cascades
    foam = torch.from_numpy(rng.uniform(0.0, 0.5, (c, n, n)).astype(np.float32)).to(dev)
    return params, state.replace(foam=foam)


def compare_maps(tag, got, ref, two_byte: bool) -> float:
    """Checks (disp, normal[, foam]) against the plain version; returns the
    max abs error."""
    e_d = rel_rms(got[0], ref[0])
    e_n = rms(got[1], ref[1]) if two_byte else rel_rms(got[1], ref[1])
    e_f = rms(got[2], ref[2]) if len(got) == 3 else 0.0
    tol_d, tol_n = (TOL_2B_DISP, TOL_2B_NORMAL) if two_byte else (TOL_F32, TOL_F32)
    log(f"    {tag}: disp {e_d:.3e} (<= {tol_d:g}), normal {e_n:.3e} (<= {tol_n:g})"
        + (f", foam {e_f:.3e} (<= {TOL_FOAM:g})" if len(got) == 3 else ""))
    check(e_d <= tol_d and e_n <= tol_n and e_f <= TOL_FOAM, f"{tag} disagrees with plain")
    return max(max_abs(a, b) for a, b in zip(got, ref))


def phase_kernel_vs_plain(torch, T, fs, dev) -> dict:
    from godotoceanwaves_tpu_torch.models.ocean import _foam_rates
    errs = {}
    for n in KERNEL_SIZES:
        params, st = seeded_inputs(torch, T, n, dev)
        dt = torch.tensor(0.1, device=dev)
        grow, decay = _foam_rates(params, dt)
        single = fs.pack_scalars(st.time + dt, params.tile_length, params.whitecap, grow, decay)
        multi = fs.pack_scalars(st.time + dt, params.tile_length, params.whitecap, grow, decay,
                                dt=dt)
        args = (st.h0, st.h0nc, st.omega, st.foam)
        dtypes = [torch.float32, torch.bfloat16] + ([torch.float16] if n == 128 else [])
        for md in dtypes:
            two_byte = md != torch.float32
            before = launches("fused_step")
            got = fs.fused_cascade_step(*args, single, map_dtype=md)
            torch.cuda.synchronize()
            check(launches("fused_step") == before + 2,
                  "fused_cascade_step did not launch the kernels")
            ref = fs.fused_cascade_step_reference(*args, single, map_dtype=md)
            errs[(n, md, 1)] = compare_maps(f"[2] N={n} {md} step", got, ref, two_byte)

            before = launches("fused_step")
            got = fs.fused_cascade_multi_step(*args, multi, num_frames=3, map_dtype=md)
            torch.cuda.synchronize()
            check(launches("fused_step") == before + 6,
                  "fused_cascade_multi_step did not launch 3 frames")
            ref = fs.fused_cascade_multi_step_reference(*args, multi, num_frames=3, map_dtype=md)
            check(tuple(got[0].shape) == (3, 3, 3, n, n), f"multi-step shape {tuple(got[0].shape)}")
            for k in range(3):
                last = (got[2],) if k == 2 else ()
                errs[(n, md, 3)] = max(errs.get((n, md, 3), 0.0), compare_maps(
                    f"[2] N={n} {md} frame {k + 1}/3", (got[0][:, k], got[1][:, k]) + last,
                    (ref[0][:, k], ref[1][:, k]) + ((ref[2],) if last else ()), two_byte))
    for n in SWEEP_SIZES:
        params, st = seeded_inputs(torch, T, n, dev)
        grow, decay = _foam_rates(params, 0.1)
        scal = fs.pack_scalars(st.time + 0.1, params.tile_length, params.whitecap, grow, decay)
        args = (st.h0, st.h0nc, st.omega, st.foam, scal)
        got = fs.fused_cascade_step(*args, map_dtype=torch.float32)
        ref = fs.fused_cascade_step_reference(*args, map_dtype=torch.float32)
        compare_maps(f"[2] N={n} {torch.float32} step", got, ref, two_byte=False)
    return errs


def phase_oracle(torch, T, fs, dev) -> float:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    n, dt = ORACLE_SIZE, 0.1
    cfg = T.SimConfig(map_size=n, map_dtype="float32")
    params = T.default_cascades(device=dev)
    state = T.init_state(cfg, params)
    before = launches("fused_step")
    _, maps = T.step(cfg, state, params, dt)
    check(launches("fused_step") == before + 2, "step() did not go through the kernel")
    got_d = host(maps.displacement[0]).transpose(1, 2, 0)
    got_n = host(maps.normal[0]).transpose(1, 2, 0)

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
    err = max(rel_rms(got_d, ref_d), rel_rms(got_n, ref_n))
    log(f"[3] oracle parity {n}^2 fp32 (kernel): rel RMS {err:.3e} (<= {TOL_ORACLE:g})")
    check(err <= TOL_ORACLE, "kernel step disagrees with tests/oracle.py")
    return err


def main_path_ocean(torch, T, dev, fused: str):
    """The config-4 session: bench.py's four cascades (the demo scene's three
    plus cascade 0 again) at 1024^2 with bf16 maps."""
    base = T.default_cascades(device=dev)
    four = base.map(lambda x: torch.cat([x, x[:1]]))
    return T.Ocean(params=four, map_size=MAIN_SIZE, map_dtype="bfloat16",
                   updates_per_second=0, device=dev, fused=fused)


def phase_main_path(torch, T, fs, dev) -> int:
    from godotoceanwaves_tpu_torch.models.ocean import multi_step
    ocean = main_path_ocean(torch, T, dev, "auto")
    reset_counts()
    for _ in range(60):
        maps = ocean.update(1 / 50)
        check(maps is not None, "uncapped update() skipped a frame")
    time_60 = ocean.state.time.clone()
    ocean.state, maps = multi_step(ocean.config, ocean.state, ocean.params, 1 / 50, 8)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["K1"]
    log(f"[4] config 4: 60 update() + multi_step(8) -> launches {counts}")
    check(counts == only(K1=2 * 68),
          f"expected {2 * 68} K1 launches and no other, counted {counts}")

    d, nm, foam = maps.displacement, maps.normal, ocean.state.foam
    check(d.dtype == torch.bfloat16, "maps are not bf16")
    check(bool(d.isfinite().all()) and bool(nm.isfinite().all()), "maps are not finite")
    check(float(foam.min()) >= 0.0 and float(foam.max()) <= 1.0, "foam left [0, 1]")
    coverage = float((foam > 0).float().mean())
    check(coverage > 0.0, "no foam at all")
    stds = [float(d[c, 1].float().std()) for c in range(4)]
    log(f"[4] height std per cascade {[round(s, 3) for s in stds]} m, foam coverage "
        f"{coverage:.3f}, time {host(ocean.state.time).tolist()}")
    check(all(0.1 <= s <= 3.0 for s in stds), "height std outside 0.1-3 m")

    staged = main_path_ocean(torch, T, dev, "never")
    reset_counts()
    for _ in range(60):
        staged.update(1 / 50)
    check(torch.equal(time_60, staged.state.time), "time after 60 updates differs from staged")
    staged.state, smaps = multi_step(staged.config, staged.state, staged.params, 1 / 50, 8)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[4] staged path (fused='never'): 60 update() + multi_step(8) -> launches {counts}")
    check(counts == only(K2=2 * 68),
          f"expected {2 * 68} K2 launches and no other, counted {counts}")
    e_d = rel_rms(d, smaps.displacement)
    e_n = rms(nm, smaps.normal)
    e_f = rms(foam, staged.state.foam)
    log(f"[4] vs staged path after 68 frames: disp {e_d:.3e} (<= {TOL_2B_DISP:g}), normal "
        f"{e_n:.3e} (<= {TOL_2B_NORMAL:g}), foam {e_f:.3e} (<= {TOL_FOAM:g})")
    check(e_d <= TOL_2B_DISP and e_n <= TOL_2B_NORMAL and e_f <= TOL_FOAM,
          "config 4 disagrees with the staged path")
    # multi_step's frame k runs at t0 + k*dt (the K1 kernel's semantics); the
    # staged loop accumulates dt, which may differ by an fp32 ulp
    check(torch.allclose(ocean.state.time, staged.state.time, rtol=1e-6, atol=0.0),
          "time after multi_step differs from the staged path")
    return launches


def turns(time_cuda, plain, kernel, iters=20):
    """Device ms per call, in turns plain, kernel, kernel, plain; returns
    (kernel ms, plain ms, the four times)."""
    t = [time_cuda(f, iters=iters) for f in (plain, kernel, kernel, plain)]
    return min(t[1], t[2]), min(t[0], t[3]), t


def time_passes(torch, tag: str, row_pass, col_pass, texels: int, planes, card: str) -> dict:
    """A step pair's row pass and column pass alone, through the library
    calls on buffers of the wrapper's shapes (bf16 maps), then the pair
    beside K2 over the same planes (`planes`, (4 C, 2, N, N)) in turns
    (pair, K2, K2, pair)."""
    from godotoceanwaves_tpu_torch.ops import planes_fft
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    check(row_pass() == 0 and col_pass() == 0, f"a {tag} pass failed to launch")
    rows_ms = time_cuda(row_pass, iters=50)
    cols_ms = time_cuda(col_pass, iters=50)
    rows_bytes = texels * (8 + 8 + 4 + 32)          # h0, h0nc, omega in; scratch out
    cols_bytes = texels * (32 + 4 + 4 + 7 * 2)      # scratch, foam in; foam, bf16 maps out
    pair = lambda: (row_pass(), col_pass())
    k2 = lambda: planes_fft.ifft2_packed_planes(planes, fold_sign=True)
    t = [time_cuda(f, iters=50) for f in (pair, k2, k2, pair)]
    pair_ms, k2_ms = min(t[0], t[3]), min(t[1], t[2])
    log(f"{tag} passes alone (CUDA events, best of 3 x 50): row pass {rows_ms:.4f} ms "
        f"({rows_bytes / rows_ms / 1e9:.3f} TB/s of {rows_bytes / 1e6:.1f} MB), column pass "
        f"{cols_ms:.4f} ms ({cols_bytes / cols_ms / 1e9:.3f} TB/s of {cols_bytes / 1e6:.1f} MB); "
        f"pair by the library calls {pair_ms:.4f} ms, K2 at {planes.shape[0]} x "
        f"{planes.shape[-1]}^2 {k2_ms:.4f} ms (turns {[round(v, 4) for v in t]}); card {card}")
    return {"rows_ms": rows_ms, "cols_ms": cols_ms, "pair_ms": pair_ms, "k2_ms": k2_ms,
            "scratch_bytes": 2 * texels * 8 * 4}


def layer_planes(torch, c: int, n: int, dev):
    """K2's yardstick input: the 4 C planes of N^2 a step pair transforms."""
    return torch.randn((4 * c, 2, n, n), generator=torch.Generator(device=dev).manual_seed(5),
                       device=dev)


def time_step_passes(torch, args, dev, card: str) -> dict:
    """K1's row pass and column pass alone at config 4, and the pair beside
    K2 at 16 x 1024^2."""
    from godotoceanwaves_tpu_torch.ops import _build, fft_plan
    h0, h0nc, omega, foam, scal = args
    lib = _build.load()
    c, n = h0.shape[0], h0.shape[-1]
    rows, cols = fft_plan.step_rows_plan(n), fft_plan.step_cols_plan(n)
    tw = fft_plan.twiddles(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = torch.empty((c, n, n, 2 * fft_plan.LAYERS), dtype=torch.float32, device=dev)
    disp = torch.empty((c, 3, n, n), dtype=torch.bfloat16, device=dev)
    normal = torch.empty((c, 4, n, n), dtype=torch.bfloat16, device=dev)
    foam_out = torch.empty_like(foam)
    row_pass = lambda: lib.fused_step_rows(
        h0.data_ptr(), h0nc.data_ptr(), omega.data_ptr(), scal.data_ptr(), tw.data_ptr(),
        scratch.data_ptr(), c, n, 0, rows.lines, rows.pitch, rows.join_pitch, stream)
    col_pass = lambda: lib.fused_step_cols(
        scratch.data_ptr(), foam.data_ptr(), scal.data_ptr(), tw.data_ptr(), disp.data_ptr(),
        normal.data_ptr(), foam_out.data_ptr(), c, n, 1, disp.stride(0), normal.stride(0),
        cols.lines, cols.pitch, cols.join_pitch, stream)
    return time_passes(
        torch, f"[5] K1 at {c} x {n}^2 bf16 (plans rows {rows.lines} x 4 layers, "
        f"{rows.threads} threads, cols {cols.lines} x 4 layers, {cols.threads} threads)",
        row_pass, col_pass, c * n * n, layer_planes(torch, c, n, dev), card)


def strip_passes(torch, args, dev):
    """K4's row pass and column pass through the library calls on buffers of
    the wrapper's shapes (bf16 maps): (row pass, column pass)."""
    from godotoceanwaves_tpu_torch.ops import _build, fft_plan
    h0, h0nc, omega, foam, scal = args
    lib = _build.load()
    c, n = h0.shape[0], h0.shape[-1]
    rows, cols = fft_plan.strip_rows_plan(n), fft_plan.strip_cols_plan(n)
    tw, twn = fft_plan.twiddles(rows.n, dev), fft_plan.twiddles(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = torch.empty((c, n, n, 2 * fft_plan.LAYERS), dtype=torch.float32, device=dev)
    disp = torch.empty((c, 3, n, n), dtype=torch.bfloat16, device=dev)
    normal = torch.empty((c, 4, n, n), dtype=torch.bfloat16, device=dev)
    foam_out = torch.empty_like(foam)
    row_pass = lambda: lib.strip_step_rows(
        h0.data_ptr(), h0nc.data_ptr(), omega.data_ptr(), scal.data_ptr(), tw.data_ptr(),
        twn.data_ptr(), scratch.data_ptr(), c, n, rows.lines, rows.pitch, rows.join_pitch, stream)
    col_pass = lambda: lib.strip_step_cols(
        scratch.data_ptr(), foam.data_ptr(), scal.data_ptr(), tw.data_ptr(), twn.data_ptr(),
        disp.data_ptr(), normal.data_ptr(), foam_out.data_ptr(), c, n, 1, disp.stride(0),
        normal.stride(0), cols.lines, cols.pitch, cols.join_pitch, stream)
    return row_pass, col_pass


def phase_timing(torch, T, fs, dev, card: str) -> tuple[float, float]:
    from godotoceanwaves_tpu_torch.models.ocean import _foam_rates, step
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    ocean = main_path_ocean(torch, T, dev, "auto")
    st, p = ocean.state, ocean.params
    dt = torch.tensor(0.02, device=dev)
    grow, decay = _foam_rates(p, dt)
    scal = fs.pack_scalars(st.time + dt, p.tile_length, p.whitecap, grow, decay)
    args = (st.h0, st.h0nc, st.omega, st.foam, scal)
    ms, plain_ms, t = turns(
        time_cuda, lambda: fs.fused_cascade_step_reference(*args, map_dtype=torch.bfloat16),
        lambda: fs.fused_cascade_step(*args, map_dtype=torch.bfloat16))
    bnd = step_bound(args, fs.fused_cascade_step(*args, map_dtype=torch.bfloat16), 4, MAIN_SIZE)
    state = [st]

    def one_step():
        state[0], _ = step(ocean.config, state[0], p, 0.02)
    step_ms = time_cuda(one_step, iters=20)
    # what a caller feels: host clock around update() calls ending in a sync
    for _ in range(5):
        ocean.update(0.02)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        ocean.update(0.02)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / 100 * 1e3
    log(f"[5] 4 x {MAIN_SIZE}^2 bf16, ms/frame (CUDA events, best of 3 x 20): kernel {ms:.4f}, "
        f"plain {plain_ms:.4f}, step() {step_ms:.4f}; turns {[round(x, 4) for x in t]}; "
        f"Ocean.update() host clock over 100 calls {update_ms:.4f}; bound {bnd[0]:.4f} "
        f"({bnd[1]}); card {card}")
    passes = time_step_passes(torch, args, dev, card)
    moved = nbytes(*args, *fs.fused_cascade_step(*args, map_dtype=torch.bfloat16))
    through = moved + passes["scratch_bytes"]
    log(f"[5] K1 pair {ms:.4f} ms: {moved / ms / 1e9:.3f} TB/s of the function's "
        f"{moved / 1e6:.1f} MB, {through / ms / 1e9:.3f} TB/s of the {through / 1e6:.1f} MB the "
        f"pair moves (scratch out and back included), {bnd[0] / ms:.1%} of its bound "
        f"{bnd[0]:.4f} ({bnd[1]}); K2 at 16 x {MAIN_SIZE}^2 in the same phase "
        f"{passes['k2_ms']:.4f} ms, K1 / K2 {ms / passes['k2_ms']:.3f}; card {card}")
    return ms, plain_ms, bnd


def config5_params(T, dev, cascades: int = 2):
    return T.models.dual_wind_swell_cascades(device=dev).map(lambda x: x[:cascades])


def strip_plain_frames(torch, ss, fs, st, p, dt, frames: int, map_dtype):
    """The plain version of `frames` strip-tier steps, as `step` runs them."""
    from godotoceanwaves_tpu_torch.models.ocean import _foam_rates
    for _ in range(frames):
        t = st.time + dt
        grow, decay = _foam_rates(p, dt)
        scal = fs.pack_scalars(t, p.tile_length, p.whitecap, grow, decay)
        d, nm, foam = ss.strip_cascade_step_reference(st.h0, st.h0nc, st.omega, st.foam, scal,
                                                      map_dtype=map_dtype)
        st = st.replace(foam=foam, time=t)
    return d, nm, foam


def phase_strip_vs_plain(torch, T, ss, fs, dev) -> dict:
    from godotoceanwaves_tpu_torch.models.ocean import _foam_rates, multi_step
    errs = {}
    dt = float(np.float32(0.1))   # as step() rounds it
    cases = [(STRIP_SIZE, 2, (torch.float32, torch.bfloat16, torch.float16))]
    cases += [(n, 1, (torch.float32, torch.bfloat16)) for n in STRIP_BIG]
    for n, cascades, dtypes in cases:
        params, st = seeded_inputs(torch, T, n, dev, config5_params(T, dev, cascades))
        grow, decay = _foam_rates(params, dt)
        scal = fs.pack_scalars(st.time + dt, params.tile_length, params.whitecap, grow, decay)
        args = (st.h0, st.h0nc, st.omega, st.foam, scal)
        for md in dtypes:
            two_byte = md != torch.float32
            before = launches("strip_step")
            got = ss.strip_cascade_step(*args, map_dtype=md)
            torch.cuda.synchronize()
            check(launches("strip_step") == before + 2,
                  "strip_cascade_step did not launch the kernels")
            check(got[0].dtype == md and tuple(got[0].shape) == (cascades, 3, n, n),
                  f"strip maps {got[0].dtype} {tuple(got[0].shape)}")
            ref = ss.strip_cascade_step_reference(*args, map_dtype=md)
            errs[(n, md, 1)] = compare_maps(f"[6] N={n} C={cascades} {md} step", got, ref,
                                            two_byte)
            del got, ref
            if n != STRIP_SIZE:
                continue
            cfg = T.SimConfig(map_size=n, map_dtype=str(md).split(".")[-1])
            check(cfg.step_tier() == "strip", f"N={n} does not route to the strip tier")
            before = launches("strip_step")
            new_st, maps = multi_step(cfg, st, params, dt, 3)
            torch.cuda.synchronize()
            check(launches("strip_step") == before + 6,
                  "multi_step(3) did not launch K4 three times")
            ref = strip_plain_frames(torch, ss, fs, st, params, dt, 3, md)
            errs[(n, md, 3)] = compare_maps(f"[6] N={n} C={cascades} {md} multi_step(3)",
                                            (maps.displacement, maps.normal, new_st.foam), ref,
                                            two_byte)
        del params, st, args
        torch.cuda.empty_cache()
    return errs


def phase_planes_vs_plain(torch, pf, fft, dev) -> dict:
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    for n in PLANES_SIZES:
        x = torch.randn((PLANES_L, 2, n, n), generator=gen, device=dev)
        for fold in (False, True):
            before = launches("planes_fft")
            got = pf.ifft2_packed_planes(x, fold_sign=fold)
            torch.cuda.synchronize()
            check(launches("planes_fft") == before + 2,
                  "ifft2_packed_planes did not launch the kernels")
            ref = fft.ifft2_packed_planes(x, fold_sign=fold)
            e = rel_rms(got, ref)
            errs[(n, fold)] = max_abs(got, ref)
            log(f"[7] K2 N={n} L={PLANES_L} fold_sign={fold}: rel RMS {e:.3e} "
                f"(<= {TOL_F32:g}), max abs {errs[(n, fold)]:.3e}")
            check(e <= TOL_F32, f"K2 at N={n} disagrees with torch.fft")
            del got, ref
        del x
        torch.cuda.empty_cache()
    return errs


def config5_ocean(T, dev, fused: str):
    """bench.py config 5: the dual wind + swell cascades at 2048^2, bf16 maps."""
    return T.Ocean(params=T.models.dual_wind_swell_cascades(device=dev), map_size=STRIP_SIZE,
                   map_dtype="bfloat16", updates_per_second=0, device=dev, fused=fused)


def stream_leg(torch, MapStreamer, tag, step_fn, host_dtype):
    """Streams STREAM_FRAMES frames; the first must equal a direct .cpu() of
    the same maps. Returns (frames/s, link MB/s, link bytes/frame)."""
    first = []

    def step():
        maps = step_fn()
        if not first:
            first.append(maps)
        return maps

    streamer = MapStreamer(step, host_dtype=host_dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = list(streamer.stream(num_frames=STREAM_FRAMES))
    seconds = time.perf_counter() - t0
    streamer.close()
    link = sum(getattr(first[0], k).numel() * getattr(first[0], k).element_size()
               for k in ("displacement", "normal"))
    for k in ("displacement", "normal"):
        direct = getattr(first[0], k).cpu()
        got = frames[0][k]
        if host_dtype is None:
            check(got.dtype == direct.dtype and torch.equal(got, direct),
                  f"{tag}: first streamed {k} differs from .cpu()")
        else:
            check(got.dtype == np.dtype(host_dtype) and np.array_equal(
                got, direct.to(torch.float32).numpy()), f"{tag}: first streamed {k} differs")
    fps = STREAM_FRAMES / seconds
    host_bytes = sum(v.nbytes if isinstance(v, np.ndarray) else v.numel() * v.element_size()
                     for v in frames[0].values())
    log(f"[8] stream {tag}: {fps:.2f} frames/s, {fps * link / 1e6:.1f} MB/s over the link, "
        f"{link} link bytes/frame, {host_bytes} host bytes/frame")
    return fps, fps * link / 1e6, link


def phase_config5(torch, T, dev) -> dict:
    from godotoceanwaves_tpu_torch.utils import MapStreamer, preview_maps
    sessions, counts = {}, {}
    for fused in ("auto", "never"):
        ocean = config5_ocean(T, dev, fused)
        reset_counts()
        for _ in range(CONFIG5_UPDATES):
            maps = ocean.update(0.02)
            check(maps is not None, "uncapped update() skipped a frame")
        torch.cuda.synchronize()
        counts[fused] = read_counts()
        sessions[fused] = ocean
        log(f"[8] config 5 fused={fused!r}: {CONFIG5_UPDATES} update() -> launches "
            f"{counts[fused]}")
    check(counts["auto"] == only(K4=2 * CONFIG5_UPDATES),
          f"config 5 expected {2 * CONFIG5_UPDATES} K4 launches only, counted {counts['auto']}")
    check(counts["never"] == only(K2=2 * CONFIG5_UPDATES),
          f"staged config 5 expected {2 * CONFIG5_UPDATES} K2 launches only, "
          f"counted {counts['never']}")

    ocean, staged = sessions["auto"], sessions["never"]
    d, nm, foam = ocean.maps.displacement, ocean.maps.normal, ocean.state.foam
    check(d.dtype == torch.bfloat16 and tuple(d.shape) == (2, 3, STRIP_SIZE, STRIP_SIZE),
          f"config 5 maps {d.dtype} {tuple(d.shape)}")
    check(bool(d.isfinite().all()) and bool(nm.isfinite().all()), "config 5 maps are not finite")
    check(float(foam.min()) >= 0.0 and float(foam.max()) <= 1.0, "config 5 foam left [0, 1]")
    stds = [float(d[c, 1].float().std()) for c in range(2)]
    coverage = float((foam > 0).float().mean())
    log(f"[8] config 5 height std per cascade {[round(s, 3) for s in stds]} m, "
        f"foam coverage {coverage:.3f}")
    # the swell cascade (22 m/s over a 900 km fetch) is the tall one: ~7 m
    check(all(0.1 <= s <= 10.0 for s in stds), "config 5 height std outside 0.1-10 m")
    e_d = rel_rms(d, staged.maps.displacement)
    e_n = rms(nm, staged.maps.normal)
    e_f = rms(foam, staged.state.foam)
    log(f"[8] config 5 K4 vs staged (K2) after {CONFIG5_UPDATES} frames: disp {e_d:.3e} "
        f"(<= {TOL_2B_DISP:g}), normal {e_n:.3e} (<= {TOL_2B_NORMAL:g}), foam {e_f:.3e} "
        f"(<= {TOL_FOAM:g})")
    check(e_d <= TOL_2B_DISP and e_n <= TOL_2B_NORMAL and e_f <= TOL_FOAM,
          "config 5 disagrees with its staged path")
    check(torch.equal(ocean.state.time, staged.state.time), "config 5 time differs from staged")
    del staged, sessions

    step = lambda: ocean.update(0.02)
    stream = {
        "full": stream_leg(torch, MapStreamer, "full resolution, fp32 host", step, np.float32),
        "native": stream_leg(torch, MapStreamer, "full resolution, native bf16", step, None),
        "preview": stream_leg(torch, MapStreamer, "preview (2x2 decimated bf16)",
                              lambda: preview_maps(ocean.update(0.02)), np.float32),
    }
    return {"launches_K4": counts["auto"]["K4"], "launches_K2": counts["never"]["K2"],
            "stream": stream}


def phase_timing_config5(torch, T, ss, pf, fs, fft, dev, card: str) -> dict:
    from godotoceanwaves_tpu_torch.models.ocean import _foam_rates, step
    from godotoceanwaves_tpu_torch.ops import fft_plan
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    out = {}
    ocean = config5_ocean(T, dev, "auto")
    st, p = ocean.state, ocean.params
    dt = 0.02
    grow, decay = _foam_rates(p, dt)
    scal = fs.pack_scalars(st.time + dt, p.tile_length, p.whitecap, grow, decay)
    args = (st.h0, st.h0nc, st.omega, st.foam, scal)
    ms, plain_ms, t = turns(
        time_cuda, lambda: ss.strip_cascade_step_reference(*args, map_dtype=torch.bfloat16),
        lambda: ss.strip_cascade_step(*args, map_dtype=torch.bfloat16))
    out["K4"] = (ms, plain_ms)
    out["K4_bound"] = step_bound(args, ss.strip_cascade_step(*args, map_dtype=torch.bfloat16), 2,
                                 STRIP_SIZE)
    state = [st]

    def one_step():
        state[0], _ = step(ocean.config, state[0], p, dt)
    step_ms = time_cuda(one_step, iters=20)

    log(f"[9] config 5 (2 x {STRIP_SIZE}^2 bf16), ms/frame (CUDA events, best of 3 x 20): K4 "
        f"{ms:.4f}, plain {plain_ms:.4f}, step() {step_ms:.4f}; turns "
        f"{[round(x, 4) for x in t]}; card {card}")
    # the two passes alone, and the pair beside K2 over the same 8 planes
    row_pass, col_pass = strip_passes(torch, args, dev)
    passes = time_passes(torch, f"[9] K4 at 2 x {STRIP_SIZE}^2 bf16", row_pass, col_pass,
                         2 * STRIP_SIZE ** 2, layer_planes(torch, 2, STRIP_SIZE, dev), card)
    out["K4_passes"] = passes
    moved = nbytes(*args, *ss.strip_cascade_step(*args, map_dtype=torch.bfloat16))
    through = moved + passes["scratch_bytes"]
    bnd = out["K4_bound"]
    log(f"[9] K4 pair {ms:.4f} ms: {moved / ms / 1e9:.3f} TB/s of the function's "
        f"{moved / 1e6:.1f} MB, {through / ms / 1e9:.3f} TB/s of the {through / 1e6:.1f} MB the "
        f"pair moves (scratch out and back included), {bnd[0] / ms:.1%} of its bound "
        f"{bnd[0]:.4f} ({bnd[1]}); K2 at 8 x {STRIP_SIZE}^2 in the same phase "
        f"{passes['k2_ms']:.4f} ms, K4 / K2 {ms / passes['k2_ms']:.3f}; card {card}")
    del ocean, st, args, state, row_pass, col_pass
    torch.cuda.empty_cache()

    # the split (N = 4096, 8192), one cascade
    for n in STRIP_BIG:
        params, st = seeded_inputs(torch, T, n, dev, config5_params(T, dev, 1))
        grow, decay = _foam_rates(params, dt)
        scal = fs.pack_scalars(st.time + dt, params.tile_length, params.whitecap, grow, decay)
        args = (st.h0, st.h0nc, st.omega, st.foam, scal)
        k_ms = time_cuda(lambda: ss.strip_cascade_step(*args, map_dtype=torch.bfloat16))
        row_pass, col_pass = strip_passes(torch, args, dev)
        check(row_pass() == 0 and col_pass() == 0, f"a K4 pass failed to launch at N={n}")
        rows_ms, cols_ms = time_cuda(row_pass), time_cuda(col_pass)
        moved = nbytes(*args, *ss.strip_cascade_step(*args, map_dtype=torch.bfloat16))
        bnd = step_bound(args, ss.strip_cascade_step(*args, map_dtype=torch.bfloat16), 1, n)
        through = moved + 2 * n * n * 32
        out[("K4", n)] = (k_ms, rows_ms, cols_ms, bnd)
        split = fft_plan.strip_rows_plan(n).split
        log(f"[9] K4 at 1 x {n}^2 bf16 (split {split}), ms (CUDA events, best of 3 x "
            f"20): pair {k_ms:.4f} ({through / k_ms / 1e9:.3f} TB/s of the {through / 1e6:.1f} MB "
            f"it moves), row pass {rows_ms:.4f}, column pass {cols_ms:.4f}; {bnd[0] / k_ms:.1%} "
            f"of its bound {bnd[0]:.4f} ({bnd[1]}); card {card}")
        del params, st, args, row_pass, col_pass
        torch.cuda.empty_cache()

    # the staged tier's frame (fused="never"): modulate, K2, unpack
    staged = config5_ocean(T, dev, "never")
    carry = [staged.state]

    def staged_step():
        carry[0], _ = step(staged.config, carry[0], staged.params, dt)
    out["staged_step"] = time_cuda(staged_step, iters=20)
    log(f"[9] config 5 staged step (fused=\"never\", K2 as its FFT), ms/frame (CUDA events, "
        f"best of 3 x 20): {out['staged_step']:.4f}; card {card}")
    del staged, carry
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(11)
    for l, n in ((16, 1024), (PLANES_L, STRIP_SIZE)):
        x = torch.randn((l, 2, n, n), generator=gen, device=dev)
        ms, plain_ms, t = turns(time_cuda, lambda: fft.ifft2_packed_planes(x, fold_sign=True),
                                lambda: pf.ifft2_packed_planes(x, fold_sign=True))
        z = torch.complex(x[:, 0], x[:, 1])
        lib_ms = time_cuda(lambda: torch.fft.ifft2(z, norm="forward"))
        bnd = bound(2 * nbytes(x), fft_flops(n, 2 * l * n))
        out[("K2", l, n)] = (ms, plain_ms, lib_ms, bnd)
        moved, through = 2 * nbytes(x), 4 * nbytes(x)   # the function's bytes; the pair's
        log(f"[9] K2 {l} x {n}^2 planes, ms (CUDA events, best of 3 x 20): kernel {ms:.4f} "
            f"({moved / ms / 1e9:.3f} TB/s of the function's {moved / 1e6:.1f} MB, "
            f"{through / ms / 1e9:.3f} TB/s of the {through / 1e6:.1f} MB the pair moves), "
            f"{bnd[0] / ms:.1%} of its bound {bnd[0]:.4f} ({bnd[1]}), "
            f"{ms / lib_ms:.3f}x torch.fft.ifft2 alone ({lib_ms:.4f}), plain {plain_ms:.4f}; "
            f"turns {[round(v, 4) for v in t]}; card {card}")
        del x, z
    return out


def render(geometry, maps, scales, cam=CAM0, **kw):
    """One frame at bench.py's render settings (sampler "auto" is "mxu" on
    the card, tap_impl "auto" the K5 kernel)."""
    return geometry.render_ocean_geometry(maps, scales, camera_pos=cam, **{**RENDER_TIER, **kw})


def lod_random_case(torch, T, shading, dev):
    """3 cascades at 1024^2 (random bf16 normals), 4 levels, the 720p native
    frame's 16 tap bands of 23 x 640 pixels; the band levels hold 0, 3 (whose
    blend engages bicubic for every default tile) and the skip value 4."""
    gen = torch.Generator(device=dev).manual_seed(10)
    normal = torch.randn((3, 4, RENDER_MAP, RENDER_MAP), generator=gen, device=dev) * 0.5
    pyr = shading.normal_gradient_pyramid(normal.to(torch.bfloat16), levels=4)
    scales = T.default_cascades(device=dev).map_scales()
    bands, pixels = 16, 23 * 640
    z0 = torch.from_numpy(np.geomspace(2.0, 900.0, bands).astype(np.float32)).to(dev)
    x = torch.rand((bands, pixels), generator=gen, device=dev) * 800.0 - 400.0
    z = z0[:, None] + torch.rand((bands, pixels), generator=gen, device=dev) * 12.0
    rows = [[0, 0, 0], [0, 1, 2], [1, 1, 3], [1, 2, 3], [2, 3, 4], [3, 3, 3], [4, 4, 4],
            [0, 4, 3], [3, 0, 1], [2, 2, 2], [1, 3, 0], [4, 0, 2], [0, 2, 4], [3, 1, 0],
            [2, 4, 1], [4, 4, 3]]
    lev = torch.tensor(rows, dtype=torch.int32, device=dev)
    return pyr, scales, torch.stack([x, z], dim=-1), lev


def captured_tap_args(torch, geometry, maps, scales, **kw) -> tuple:
    """The arguments `gradient_lod_tap` receives in one frame, taken by a
    one-call wrapper around it (the frame runs as usual)."""
    from godotoceanwaves_tpu_torch.ops import tap
    seen, real = [], tap.gradient_lod_tap
    tap.gradient_lod_tap = lambda *args: seen.append(args) or real(*args)
    try:
        render(geometry, maps, scales, **kw)
    finally:
        tap.gradient_lod_tap = real
    check(len(seen) == 1, f"the frame called gradient_lod_tap {len(seen)} times, not once")
    return seen[0]


def phase_tap_vs_plain(torch, T, dev, maps, scales) -> dict:
    from godotoceanwaves_tpu_torch.models import geometry, shading
    from godotoceanwaves_tpu_torch.ops import tap
    args = lod_random_case(torch, T, shading, dev)
    before = launches("tap")
    got = tap.gradient_lod_tap(*args)
    torch.cuda.synchronize()
    check(launches("tap") == before + 1, "gradient_lod_tap did not launch the kernel")
    want = tap.gradient_lod_tap_reference(*args)
    e_rand = max_abs(got, want)
    check(bool((got[6] == 0).all()), "a skipped band was tapped")
    log(f"[10] K5 random case (16 bands x {args[2].shape[1]} px, 3 x {RENDER_MAP}^2, 4 levels):"
        f" max abs {e_rand:.3e} (<= {TOL_TAP:g}); output mean |.| {float(want.abs().mean()):.3f}")
    check(e_rand <= TOL_TAP, "K5 disagrees with its plain version (random case)")
    kw = dict(width=640, height=360, _debug_stage="grad")
    before = launches("tap")
    got = render(geometry, maps, scales, **kw)
    torch.cuda.synchronize()
    check(launches("tap") == before + 1, "the render's gradient stage did not launch K5 once")
    want = render(geometry, maps, scales, tap_impl="einsum", **kw)
    e_real = max_abs(got, want)
    log(f"[10] K5 real 640x360 frame gradient (_debug_stage='grad'), kernel route vs "
        f"tap_impl='einsum': max abs {e_real:.3e} (<= {TOL_TAP:g})")
    check(e_real <= TOL_TAP, "K5 disagrees with its plain version (real frame)")
    frame = captured_tap_args(torch, geometry, maps, scales, **RENDER_LEGS[TAP_FRAME])
    e_frame = max_abs(tap.gradient_lod_tap(*frame), tap.gradient_lod_tap_reference(*frame))
    pyr, _, xz, lev = frame
    log(f"[10] K5 on the arguments of one {TAP_FRAME} frame ({xz.shape[0]} bands x "
        f"{xz.shape[1]} px, {len(pyr)} {pyr[0].dtype} levels of {tuple(pyr[0].shape)}, level "
        f"counts {torch.bincount(lev.reshape(-1).long(), minlength=len(pyr) + 1).tolist()}): "
        f"max abs {e_frame:.3e} (<= {TOL_TAP:g})")
    check(e_frame <= TOL_TAP, f"K5 disagrees with its plain version ({TAP_FRAME} frame)")
    return {"random": e_rand, "real": max(e_real, e_frame), "args": args, "frame_args": frame}


def march_case(torch, geometry, maps, scales, dev, width=640, height=360):
    """K6's inputs in a real frame: the G = 256 march table of the displaced
    grid under the bench camera, its rays and march windows."""
    coords = geometry._on_device(dev, geometry.clipmap_axis_coords, "high")
    cam = torch.tensor(CAM0, device=dev)
    center = torch.ceil(cam[0::2])
    grid = geometry.displaced_grid(maps, scales, coords, center, cam, sampler="mxu")
    table = geometry.uniform_from_graded(grid, "high", 256)[..., 1]
    _, _, origin, cell = geometry._uniform_resample_tables("high", 256)
    d = geometry.camera_rays(width, height, -12.0, 0.0, 70.0, device=dev)
    t0, t1, ok = geometry.march_window(cam, d, grid, coords, center, 1600.0)
    return table, d, t0, t1, ok, cam, center, origin, cell


def phase_march_vs_plain(torch, dev, maps, scales) -> dict:
    from godotoceanwaves_tpu_torch.models import geometry
    from godotoceanwaves_tpu_torch.ops import march
    out = {"agree": 1.0, "max_abs": 0.0, "args": {}}
    for w, h in MARCH_RAYS:
        args = march_case(torch, geometry, maps, scales, dev, width=w, height=h)
        before = launches("march")
        found, lo, hi = march.march_heightfield(*args, **MARCH_RUN)
        torch.cuda.synchronize()
        check(launches("march") == before + 1, "march_heightfield did not launch the kernel")
        wf, wlo, whi = march.march_heightfield_reference(*args, **MARCH_RUN)
        agree = float((found == wf).float().mean())
        both = found & wf
        rel = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1e-6))[both].max())
        e_lo, e_hi = rel(lo, wlo), rel(hi, whi)
        err = max(float((lo - wlo).abs()[both].max()), float((hi - whi).abs()[both].max()))
        log(f"[11] K6 {w}x{h} rays, G=256, 32 steps + 2 rounds: found agrees on {agree:.6f} "
            f"(>= {MARCH_FOUND}); hit share {float(wf.float().mean()):.3f}; rel lo {e_lo:.3e}, "
            f"hi {e_hi:.3e} (<= {TOL_MARCH:g}); max abs {err:.3e}")
        check(agree >= MARCH_FOUND and e_lo <= TOL_MARCH and e_hi <= TOL_MARCH,
              "K6 disagrees with its plain version")
        out["agree"], out["max_abs"] = min(out["agree"], agree), max(out["max_abs"], err)
        out["args"][f"{w}x{h}"] = args
    return out


def phase_render_path(torch, dev, ocean) -> dict:
    from godotoceanwaves_tpu_torch.models import geometry
    scales = ocean.params.map_scales()
    reset_counts()
    maps = ocean.update(1 / 60)
    imgs = {leg: render(geometry, maps, scales, **kw) for leg, kw in RENDER_LEGS.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[12] Ocean.update() + the three render legs -> launches {counts}")
    check(counts == only(K1=2, K5=3, fan=3),
          f"expected 2 K1, one K5 and one fan select per frame and no other, counted {counts}")
    small = next(iter(RENDER_LEGS))
    reset_counts()
    pal = render(geometry, maps, scales, march_impl="pallas", **RENDER_LEGS[small])
    torch.cuda.synchronize()
    pal_counts = read_counts()
    log(f"[12] one march_impl='pallas' {small} frame -> launches {pal_counts}")
    check(pal_counts == only(K5=1, K6=1),
          f"expected one K5 and one K6 launch, counted {pal_counts}")

    out = {"launches_K5": counts["K5"], "launches_K6": pal_counts["K6"], "frame_err": {}}
    for leg, kw in RENDER_LEGS.items():
        img = imgs[leg]
        check(tuple(img.shape) == (kw["height"], kw["width"], 3), f"{leg}: shape {img.shape}")
        check(bool(img.isfinite().all()) and float(img.min()) >= 0.0
              and float(img.max()) <= 1.0, f"{leg}: image not finite in [0, 1]")
        plain = render(geometry, maps, scales, tap_impl="einsum", **kw)
        e = float((img - plain).abs().mean())
        out["frame_err"][leg] = e
        log(f"[12] {leg}: kernel route vs plain route mean |delta| {e:.3e} (<= {TOL_FRAME:g}), "
            f"max {max_abs(img, plain):.3e}; image mean {float(img.mean()):.4f}")
        check(e <= TOL_FRAME, f"{leg}: kernel-route frame disagrees with the plain route")
    for leg, kw in RENDER_LEGS.items():
        if kw.get("render_scale", 1) > 1:
            continue
        hit = render(geometry, maps, scales, _debug_stage="march", **kw)[..., 1]
        sky = 1.0 - float(hit.mean())
        log(f"[12] {leg}: sky share {sky:.4f} (0.05 .. 0.6)")
        check(0.05 <= sky <= 0.6, f"{leg}: implausible sky share {sky}")
    e_pal = float((pal - imgs[small]).abs().mean())
    log(f"[12] march_impl='pallas' vs the fan march at {small}: mean |delta| {e_pal:.3e}")
    check(bool(pal.isfinite().all()) and e_pal <= 2e-2, "the K6 frame is far from the fan frame")
    cam = torch.tensor(CAM0, device=dev)
    for leg, kw in RENDER_LEGS.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            img = render(geometry, maps, scales, cam=cam, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(max_abs(img, imgs[leg]) <= 1e-6, f"{leg}: the sync-checked frame differs")
    log("[12] one frame per leg under torch.cuda.set_sync_debug_mode('error'): no host sync")
    out["maps"], out["scales"] = maps, scales
    return out


def profile_frames(torch, frame, leg: str, host_ms: float, reps: int = 3, phase: int = 13,
                   stem: str = "render_profile", ranges: tuple = ()) -> dict:
    """Device time per frame by kernel under torch.profiler (kernel rows
    only): the device's busy share against the unprofiled host-clock frame
    time, the launch count, and the top kernels (the full table goes to
    build/, which .gitignore lists). `ranges` names record_function spans
    whose device time (their kernels' time) is returned per frame too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            frame()
        torch.cuda.synchronize()
    rows, kernel_sums, extents = [], {}, {}
    for e in prof.key_averages():
        if e.key in ranges:
            # the CPU row sums the device time of the kernels launched in
            # the span; the device row is the span's extent on the device
            on_device = getattr(e, "device_type", None) == DeviceType.CUDA
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "cuda_time_total", 0.0)
            (extents if on_device else kernel_sums)[e.key] = dev_us / reps / 1e3
            continue
        if getattr(e, "device_type", None) != DeviceType.CUDA or e.is_user_annotation:
            continue            # the ops' rows repeat their kernels' device time; a
            # span's device row (a gpu_user_annotation) is its extent, no operation
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / reps / 1e3, e.count / reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"{stem}_{leg.split()[0]}.txt"), "w") as f:
        for ms, count, key in rows:
            f.write(f"{ms:10.4f} ms {count:8.1f} x  {key}\n")
    log(f"[{phase}] {leg} under torch.profiler: device busy {busy:.3f} ms/frame in "
        f"{launches:.0f} kernel launches, {busy / host_ms:.1%} of the {host_ms:.3f} ms host-clock "
        f"frame")
    for ms, count, key in rows[:8]:
        log(f"[{phase}]     {ms:8.4f} ms/frame {count:6.1f} x  {key[:90]}")
    spans = {k: kernel_sums.get(k) or extents.get(k, 0.0) for k in set(kernel_sums) | set(extents)}
    for k in sorted(spans):
        log(f"[{phase}]     span {k}: kernels {kernel_sums.get(k, 0.0):.4f} ms/frame, device "
            f"extent {extents.get(k, 0.0):.4f}")
    return {"busy_ms": busy, "launches": launches, "top": rows[:8], "spans_ms": spans}


def tap_flops(pyramid, scales, xz, levels) -> float:
    """The taps' multiply-adds that this run's bands need: 2x2 texels x 3
    channels a (pixel, cascade), 4x4 more where the cubic blend engages
    (csrc/tap.cu), none where the band skips the cascade; weights not
    counted."""
    res, nlev, pixels = pyramid[0].shape[-1], len(pyramid), xz.shape[1]
    sc = scales.cpu().tolist()
    taps = 0
    for row in levels.cpu().tolist():
        for c, lev in enumerate(row):
            if lev >= nlev:
                continue
            n = res >> max(lev, 0)
            taps += 4 + (16 if min(1.0, n * min(sc[c][0], sc[c][1]) * 0.1) < 1.0 else 0)
    return 2.0 * 3 * taps * pixels


def march_flops(torch, args, found, lo, steps: int, rounds: int) -> float:
    """The samples that this run's rays need, 4 texels (a multiply and an
    add each) a sample: up to the first crossing of the `steps`-sample march
    (all of them where none is found), then `rounds` x 8 refinement samples
    where one is."""
    _, _, t0, t1, valid = args[:5]
    t0, t1, valid = t0.reshape(-1), t1.reshape(-1), valid.reshape(-1)
    found, lo = found.reshape(-1), lo.reshape(-1)
    seg = (t1 - t0) / steps
    first = torch.clamp(torch.floor((lo - t0) / seg) + 1.0, 1.0, float(steps))
    samples = torch.where(found, first + 8.0 * rounds, torch.full_like(first, steps))
    return 8.0 * float(torch.where(valid, samples, torch.zeros_like(samples)).sum())


def tap_bytes(torch, pyramid, scales, xz, levels, out) -> int:
    """The bytes K5's function must move for these inputs: each distinct
    texel the taps touch (2x2, or 4x4 where the cubic blend engages, on the
    band's level; none where the band skips the cascade) x 3 channels x the
    levels' element size, plus the scales, xz, the band levels and the
    output once. Texel indices from the plain version's `_wrap_taps`."""
    from godotoceanwaves_tpu_torch.models import shading
    nlev, res = len(pyramid), pyramid[0].shape[-1]
    base = [0]
    for p in pyramid:
        base.append(base[-1] + p.shape[0] * p.shape[-1] ** 2)
    ids = []
    for b, row in enumerate(levels.cpu().tolist()):
        for c, lev in enumerate(row):
            if lev >= nlev:
                continue
            lev = max(lev, 0)
            n, s = res >> lev, scales[c]
            cubic = bool(torch.clamp_max(n * torch.minimum(s[0], s[1]) * 0.1, 1.0) < 1.0)
            uv = xz[b] * s[:2]
            ix = torch.stack([i for i, _ in shading._wrap_taps(uv[:, 0] * n - 0.5, n, cubic)])
            iv = torch.stack([i for i, _ in shading._wrap_taps(uv[:, 1] * n - 0.5, n, cubic)])
            ids.append((base[lev] + (c * n + iv[:, None]) * n + ix[None]).reshape(-1))
    texels = int(torch.unique(torch.cat(ids)).numel()) if ids else 0
    return texels * 3 * pyramid[0].element_size() + nbytes(scales, xz, levels, out)


def device_profile(torch, call, name: str) -> tuple[list, list, list]:
    """Per repeat of ALONE_CALLS back-to-back calls under torch.profiler
    (device rows only): the device ms of a launch of the kernel whose name
    holds `name`, the device ms a call of every device operation (kernels,
    copies, fills), and the number of those operations a call. A call is
    one launch of the named kernel, so a call's figures are per launch of
    it: the profiler may miss the first launches of a window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    own, busy, ops = [], [], []
    for _ in range(ALONE_REPEATS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(ALONE_CALLS):
                call()
            torch.cuda.synchronize()
        us = total = 0.0
        launches = count = 0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA or e.is_user_annotation:
                continue            # a span's device row is its extent, no operation
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            count += e.count
            total += dev_us
            if name in e.key:
                us += dev_us
                launches += e.count
        check(launches > 0, f"no launch of {name} under the profiler")
        own.append(us / launches / 1e3)
        busy.append(total / launches / 1e3)
        ops.append(count / launches)
    return own, busy, ops


def call_times(torch, call) -> list:
    """Per repeat, CUDA events around ALONE_CALLS back-to-back calls: ms a
    call, host and device together (whichever is slower sets it)."""
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(ALONE_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ALONE_CALLS):
            call()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / ALONE_CALLS)
    return out


def spread(values: list) -> str:
    v = sorted(values)
    return f"{v[len(v) // 2]:.4f} (min {v[0]:.4f}, max {v[-1]:.4f}, {len(v)} repeats)"


def time_alone(torch, tag: str, name: str, call, plain_ms: float, moved: float, flops: float,
               card: str) -> dict:
    """One kernel's block of timings: kernel-only device time and device
    operations a call (torch.profiler), the whole wrapper call (CUDA
    events), beside the bound and the plain version's time."""
    own, busy, ops = device_profile(torch, call, name)
    whole = call_times(torch, call)
    bnd = bound(moved, flops)
    med = lambda v: sorted(v)[len(v) // 2]
    log(f"[17] {tag}: kernel {spread(own)} ms ({bnd[0] / med(own):.1%} of its bound "
        f"{bnd[0]:.4f} ({bnd[1]}), {moved / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); every device "
        f"operation of a call {spread(busy)} ms, {max(ops):g} operations a call; whole call "
        f"{spread(whole)} ms; plain {plain_ms:.4f} ms (timed once); card {card}")
    return {"ms": med(own), "device_ms": med(busy), "call_ms": med(whole), "ms_all": own,
            "call_ms_all": whole, "ops_per_call": max(ops), "plain_ms": plain_ms, "bound": bnd}


def phase_kernels_alone(torch, tap_res, march_res, card: str) -> dict:
    """K5 and K6 alone, each in its own block: K5 on the random case and on
    the arguments of one TAP_FRAME frame, K6 on MARCH_RAYS rays."""
    from godotoceanwaves_tpu_torch.ops import march, tap
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    once = lambda fn: time_cuda(fn, iters=1, warmup=1, repeats=1)
    out = {}
    for case, args in (("random", tap_res["args"]), ("frame", tap_res["frame_args"])):
        pyr, scales, xz, lev = args
        call = lambda: tap.gradient_lod_tap(*args)
        moved = tap_bytes(torch, pyr, scales, xz, lev, call())
        tag = (f"K5 {case} ({xz.shape[0]} bands x {xz.shape[1]} px, {len(pyr)} {pyr[0].dtype} "
               f"levels of {tuple(pyr[0].shape)})")
        out[f"K5 {case}"] = time_alone(torch, tag, "lod_tap_kernel", call,
                                       once(lambda: tap.gradient_lod_tap_reference(*args)),
                                       moved, tap_flops(*args), card)
    for size, args in march_res["args"].items():
        call = lambda: march.march_heightfield(*args, **MARCH_RUN)
        found, lo, hi = call()
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        moved = nbytes(*tensors, found, lo, hi)
        flops = march_flops(torch, args, found, lo, MARCH_RUN["march_steps"],
                            MARCH_RUN["refine_rounds"])
        out[f"K6 {size}"] = time_alone(
            torch, f"K6 {size} rays, G = {args[0].shape[0]}, 32 steps + 2 rounds", "march_kernel",
            call, once(lambda: march.march_heightfield_reference(*args, **MARCH_RUN)), moved,
            flops, card)
    return out


def alone_entry(res: dict, suffix: str = "") -> dict:
    """A kernels-line entry's timing keys from `time_alone`: kernel-only ms,
    every device operation of a call, the whole call, the plain version, the
    bound."""
    return {f"ms{suffix}": res["ms"], f"device_ms{suffix}": res["device_ms"],
            f"call_ms{suffix}": res["call_ms"],
            f"plain_ms{suffix}": res["plain_ms"], f"bound_ms{suffix}": res["bound"][0],
            f"bound_by{suffix}": res["bound"][1],
            f"device_ops_per_call{suffix}": res["ops_per_call"]}


def phase_render_timing(torch, dev, maps, scales, card: str) -> dict:
    from godotoceanwaves_tpu_torch.models import geometry
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    cam0 = torch.tensor(CAM0, device=dev)
    out = {}

    def chained(**kw):
        """Frames chained through a bounded camera nudge: each frame waits
        for the last, and the pose moves by at most 1e-6 m."""
        carry = [torch.zeros((), device=dev)]

        def frame():
            img = render(geometry, maps, scales, cam=cam0 + torch.tanh(carry[0]) * 1e-6, **kw)
            carry[0] = img.sum()
        return frame

    for leg, kw in list(RENDER_LEGS.items()) * 2:       # twice: the spread between passes
        ms = time_cuda(chained(**kw), iters=10, warmup=2)
        frame = chained(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            frame()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        render(geometry, maps, scales, **kw)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        prev = out.get(leg, {"ms": float("inf"), "host_ms": float("inf")})
        out[leg] = {"ms": min(ms, prev["ms"]), "host_ms": min(host_ms, prev["host_ms"]),
                    "peak_GiB": peak}
        log(f"[13] {leg}: {ms:.3f} ms/frame (CUDA events, best of 3 x 10, chained), host clock "
            f"{host_ms:.3f} ms/frame over 10 chained frames, peak {peak:.3f} GiB above the "
            f"resident {base / 2 ** 30:.3f} GiB; card {card}")
    for leg in ("640x360", "1280x720 native"):
        if leg in RENDER_LEGS:
            out[f"profile {leg}"] = profile_frames(torch, chained(**RENDER_LEGS[leg]), leg,
                                                   out[leg]["host_ms"])
    for w, h in ((640, 360), (1280, 720)):
        split = {st: time_cuda(chained(width=w, height=h, _debug_stage=st), iters=10, warmup=2)
                 for st in ("march", "uv", "grad", None)}
        out[f"split {w}x{h}"] = split
        log(f"[13] {w}x{h} cumulative stages, ms: march {split['march']:.3f}, uv "
            f"{split['uv']:.3f}, grad {split['grad']:.3f}, full {split[None]:.3f}; card {card}")
    marches = {impl: time_cuda(chained(width=640, height=360, march_impl=impl,
                                       _debug_stage="march"), iters=10, warmup=2)
               for impl in ("fan", "pallas", "xla")}
    out["march_stage"] = marches
    log(f"[13] 640x360 march stage (rays + tables + march), ms: fan {marches['fan']:.3f}, "
        f"K6 (pallas) {marches['pallas']:.3f}, xla bracket {marches['xla']:.3f}; card {card}")

    return out


def phase_rows_vs_plain(torch, rf, fft, dev) -> dict:
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(14)
    for l, r, n in ROWS_SHAPES:
        x = torch.randn((l, 2, r, n), generator=gen, device=dev)
        for fold in (False, True):
            before = launches("rows_fft")
            got = rf.idft_rows_planes(x, fold_sign=fold)
            torch.cuda.synchronize()
            check(launches("rows_fft") == before + 1, "idft_rows_planes did not launch the kernel")
            ref = fft.idft_rows_planes(x, fold_sign=fold)
            e = rel_rms(got, ref)
            errs[(l, r, n, fold)] = max_abs(got, ref)
            log(f"[14] K3 ({l}, 2, {r}, {n}) fold_sign={fold}: rel RMS {e:.3e} (<= {TOL_F32:g}), "
                f"max abs {errs[(l, r, n, fold)]:.3e}")
            check(e <= TOL_F32, f"K3 at ({l}, 2, {r}, {n}) disagrees with torch.fft")
            del got, ref
        del x
    torch.cuda.empty_cache()
    return errs


def patch0(par, sharded, dev):
    """Patch 0 of a sharded state or maps, assembled on `dev`."""
    part = par.sharding.Sharded(sharded.mesh, sharded.blocks[:1]).gather(dev)
    return type(part)(**{k: v[0] for k, v in vars(part).items()})


def compare_fp32(tag, got, ref) -> float:
    """(disp, normal, foam) at fp32: maps relative, foam absolute RMS."""
    e_d, e_n, e_f = rel_rms(got[0], ref[0]), rel_rms(got[1], ref[1]), rms(got[2], ref[2])
    log(f"    {tag}: disp {e_d:.3e}, normal {e_n:.3e} (<= {TOL_F32:g}), foam {e_f:.3e} "
        f"(<= {TOL_FOAM:g})")
    check(e_d <= TOL_F32 and e_n <= TOL_F32 and e_f <= TOL_FOAM, f"{tag} disagrees")
    return max(max_abs(a, b) for a, b in zip(got, ref))


def phase_sharded_main(torch, T, par, dev) -> dict:
    """Config 4's shape on a (1, 8) mesh of the card vs the unsharded step (K1)."""
    n, rows = MAIN_SIZE, SHARD_ROWS_MAIN
    base = T.default_cascades(device=dev)
    params = par.multipatch_params(base.map(lambda x: torch.cat([x, x[:1]])), 1, seed=0)
    cfg = T.SimConfig(map_size=n)
    mesh = par.build_mesh([dev] * rows, rows=rows)
    state = par.make_multichip_init(mesh, cfg)(params)
    p0 = params.map(lambda x: x[0])
    ref_state = T.init_state(cfg, p0)
    first = patch0(par, state, dev)
    e_init = max(rel_rms(first.h0, ref_state.h0), rel_rms(first.h0nc, ref_state.h0nc))
    log(f"[15] sharded init (1, {rows}) vs init_state at 4 x {n}^2: h0/h0nc rel RMS {e_init:.3e}")
    check(e_init <= TOL_F32 and torch.equal(first.omega, ref_state.omega)
          and torch.equal(first.time, ref_state.time), "the sharded init differs from init_state")
    step = par.make_multichip_step(mesh, cfg)
    frames = []
    reset_counts()
    for _ in range(SHARD_FRAMES):
        state, maps = step(state, params, 0.02)
        frames.append((maps, state))
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[15] config 4 sharded (1, {rows}), {SHARD_FRAMES} frames -> launches {counts}")
    check(counts == only(K3=2 * rows * SHARD_FRAMES),
          f"expected {2 * rows * SHARD_FRAMES} K3 launches and no other, counted {counts}")
    err = 0.0
    for k, (maps, st) in enumerate(frames):
        ref_state, ref = T.step(cfg, ref_state, p0, 0.02)
        got = patch0(par, maps, dev)
        err = max(err, compare_fp32(f"[15] frame {k + 1} vs step() (K1)",
                                    (got.displacement, got.normal, patch0(par, st, dev).foam),
                                    (ref.displacement, ref.normal, ref_state.foam)))
    check(torch.equal(patch0(par, state, dev).time, ref_state.time), "sharded time differs")
    return {"launches": counts["K3"], "max_abs": err}


def phase_sharded_config5(torch, T, par, dev) -> dict:
    """BASELINE config 5 at 8 patches on a (4, 2) mesh of the card."""
    from godotoceanwaves_tpu_torch.models import geometry
    from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
    n = STRIP_SIZE
    params = par.multipatch_params(T.models.dual_wind_swell_cascades(device=dev), SHARD_PATCHES)
    cfg = T.SimConfig(map_size=n, map_dtype="bfloat16")
    cfg32 = T.SimConfig(map_size=n)
    mesh = par.build_mesh([dev] * SHARD_PATCHES, rows=SHARD_ROWS_C5)
    t0 = time.perf_counter()
    state = par.make_multichip_init(mesh, cfg)(params)
    torch.cuda.synchronize()
    log(f"[15] config 5 sharded init, mesh {mesh.shape}, {SHARD_PATCHES} x 2 x {n}^2: "
        f"{time.perf_counter() - t0:.2f} s")
    step = par.make_multichip_step(mesh, cfg)
    positions = SHARD_PATCHES
    reset_counts()
    for _ in range(CONFIG5_UPDATES):
        state, maps = step(state, params, 0.02)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[15] config 5 sharded, {CONFIG5_UPDATES} updates -> launches {counts}")
    check(counts == only(K3=2 * positions * CONFIG5_UPDATES),
          f"expected {2 * positions * CONFIG5_UPDATES} K3 launches and no other, counted {counts}")

    t0 = time.perf_counter()
    host = par.gather_maps(maps)
    log(f"[15] gather_maps: {tuple(host.displacement.shape)} {host.displacement.dtype} + "
        f"{tuple(host.normal.shape)} on the host in {time.perf_counter() - t0:.2f} s")
    check(tuple(host.displacement.shape) == (SHARD_PATCHES, 2, 3, n, n)
          and tuple(host.normal.shape) == (SHARD_PATCHES, 2, 4, n, n)
          and host.displacement.dtype == torch.bfloat16 and host.displacement.device.type == "cpu",
          "gather_maps returned the wrong global maps")
    stds = []
    for p in range(SHARD_PATCHES):
        d, nm = host.displacement[p].float(), host.normal[p].float()
        check(bool(d.isfinite().all()) and bool(nm.isfinite().all()), f"patch {p} not finite")
        stds.append([round(float(d[c, 1].std()), 3) for c in range(2)])
    foam = state.gather(dev).foam
    coverage = float((foam > 0).float().mean())
    log(f"[15] config 5 height std per patch and cascade {stds} m, foam in "
        f"[{float(foam.min()):.3f}, {float(foam.max()):.3f}], coverage {coverage:.3f}")
    check(float(foam.min()) >= 0.0 and float(foam.max()) <= 1.0, "sharded foam left [0, 1]")
    check(all(0.1 <= s <= 10.0 for row in stds for s in row), "height std outside 0.1-10 m")
    del host, foam

    st0, p0 = patch0(par, state, dev), params.map(lambda x: x[0])
    before = launches("strip_step")
    ref_state, ref = T.step(cfg32, st0, p0, 0.02)
    torch.cuda.synchronize()
    check(launches("strip_step") == before + 2, "the single-patch step did not run K4")
    state32, maps32 = par.make_multichip_step(mesh, cfg32)(state, params, 0.02)
    got = patch0(par, maps32, dev)
    err = compare_fp32("[15] config 5 patch 0, one fp32 frame vs step() (K4)",
                       (got.displacement, got.normal, patch0(par, state32, dev).foam),
                       (ref.displacement, ref.normal, ref_state.foam))
    del ref_state, ref, st0, got

    _, want = step(state, params, 0.02)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, checked = step(state, params, 0.02)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(max_abs(patch0(par, checked, dev).displacement, patch0(par, want, dev).displacement)
          <= 1e-6, "the sync-checked sharded frame differs")
    log("[15] one sharded config-5 frame under torch.cuda.set_sync_debug_mode('error'): no host "
        "sync")
    del want, checked

    ckpt = os.path.join(ROOT, "build", "sharded_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    par.save_sharded(ckpt, state)
    mesh_b = par.build_mesh([dev] * SHARD_PATCHES, rows=2 * SHARD_ROWS_C5)
    restored = par.restore_sharded(ckpt, mesh_b, state)
    seconds = time.perf_counter() - t0
    shutil.rmtree(ckpt)
    cont, cont_maps = par.make_multichip_step(mesh_b, cfg32)(restored, params, 0.02)
    e_foam = max_abs(cont.gather(dev).foam, state32.gather(dev).foam)
    e_disp = max_abs(cont_maps.gather(dev).displacement, maps32.gather(dev).displacement)
    log(f"[15] checkpoint on {mesh.shape}, restored on {mesh_b.shape} ({seconds:.2f} s), one "
        f"frame on: foam max abs {e_foam:.3e} (<= {TOL_RESTORE_FOAM:g}), displacement "
        f"{e_disp:.3e} (<= {TOL_RESTORE_DISP:g}) vs the unbroken run")
    check(e_foam <= TOL_RESTORE_FOAM and e_disp <= TOL_RESTORE_DISP,
          "the restored run differs from the unbroken run")
    del restored, cont, cont_maps, state32, maps32
    torch.cuda.empty_cache()

    m0 = patch0(par, maps, dev)
    maps0 = OceanMaps(displacement=m0.displacement, normal=m0.normal)
    scales0 = params.map_scales()[0]
    size = RENDER_LEGS["640x360"]
    # per-pixel march: the fan march groups rows by the largest divisor of
    # the band height (geometry._fan_select), 3 rows in a 45-row band
    # against 4 in the full frame
    exact = dict(RENDER_TIER, sampler="gather", gradient_lod=False, shade_res=1,
                 march_impl="xla", **size)
    dense = geometry.render_ocean_geometry(maps0, scales0, camera_pos=CAM0, **exact)
    banded = par.render_geometry_sharded(mesh, maps0, scales0, camera_pos=CAM0, **exact)
    e_band = max_abs(banded, dense)
    log(f"[15] render_geometry_sharded of patch 0, 640x360 over {SHARD_PATCHES} bands (gather, "
        f"no LOD, shade_res=1, per-pixel march) vs the dense frame: max abs {e_band:.3e} "
        f"(<= {TOL_BANDS:g})")
    check(tuple(banded.shape) == (size["height"], size["width"], 3) and e_band <= TOL_BANDS,
          "the banded frame differs from the dense frame")
    img = par.render_geometry_sharded(mesh, maps0, scales0, camera_pos=CAM0, **RENDER_TIER, **size)
    check(bool(img.isfinite().all()) and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
          "the banded interactive frame is not finite in [0, 1]")
    hit = par.render_geometry_sharded(mesh, maps0, scales0, camera_pos=CAM0, _debug_stage="march",
                                      **RENDER_TIER, **size)[..., 1]
    dense_hit = geometry.render_ocean_geometry(maps0, scales0, camera_pos=CAM0,
                                               _debug_stage="march", **RENDER_TIER, **size)[..., 1]
    sky, dense_sky = 1.0 - float(hit.mean()), 1.0 - float(dense_hit.mean())
    log(f"[15] banded interactive 640x360 frame: mean {float(img.mean()):.4f}, sky share "
        f"{sky:.4f} (dense frame {dense_sky:.4f})")
    check(0.01 <= sky <= 0.9 and abs(sky - dense_sky) <= 0.02, f"implausible sky share {sky}")
    return {"launches": counts["K3"], "max_abs": err, "state": state, "params": params,
            "mesh": mesh, "config": cfg, "band_err": e_band, "sky": sky}


def phase_sharded_timing(torch, par, rf, fft, dev, c5, card: str) -> dict:
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    out = {}
    l, r, n = ROWS_SHAPES[0]
    x = torch.randn((l, 2, r, n), generator=torch.Generator(device=dev).manual_seed(16),
                    device=dev)
    ms, plain_ms, t = turns(time_cuda, lambda: fft.idft_rows_planes(x, fold_sign=True),
                            lambda: rf.idft_rows_planes(x, fold_sign=True))
    z = torch.complex(x[:, 0], x[:, 1])
    lib_ms = time_cuda(lambda: torch.fft.ifft(z, dim=-1, norm="forward"))
    bnd = bound(2 * nbytes(x), fft_flops(n, l * r))
    out["K3"] = (ms, plain_ms, lib_ms, bnd)
    log(f"[16] K3 ({l}, 2, {r}, {n}), ms (CUDA events, best of 3 x 20): kernel {ms:.4f} "
        f"({2 * nbytes(x) / ms / 1e9:.3f} TB/s of {2 * nbytes(x) / 1e6:.1f} MB), "
        f"{bnd[0] / ms:.1%} of its bound {bnd[0]:.4f} ({bnd[1]}), {ms / lib_ms:.3f}x "
        f"torch.fft.ifft alone ({lib_ms:.4f}), plain {plain_ms:.4f}; "
        f"turns {[round(v, 4) for v in t]}; card {card}")
    del x, z

    state, params, mesh, cfg = c5["state"], c5["params"], c5["mesh"], c5["config"]
    step = par.make_multichip_step(mesh, cfg)
    carry = [state]

    def one_step():
        carry[0], _ = step(carry[0], params, 0.02)
    step_ms = time_cuda(one_step, iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    one_step()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30

    prof = profile_frames(torch, one_step, f"config5_sharded {mesh.shape}", host_ms, phase=16,
                          stem="sharded_profile", ranges=SHARDED_SPANS)
    check(set(prof["spans_ms"]) == set(SHARDED_SPANS),
          f"the trace lacks spans of the sharded step: {sorted(prof['spans_ms'])}")
    split = {k.split("/")[1]: v for k, v in prof["spans_ms"].items()}

    mesh_81 = par.build_mesh([dev] * SHARD_PATCHES, rows=1)
    carry_81 = [par.shard_state(mesh_81, carry[0].gather(dev))]
    step_81 = par.make_multichip_step(mesh_81, cfg)

    def one_step_81():
        carry_81[0], _ = step_81(carry_81[0], params, 0.02)
    reset_counts()
    one_step_81()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == only(K4=2 * SHARD_PATCHES),
          f"a (8, 1) mesh step should be {SHARD_PATCHES} K4 steps, counted {counts}")
    ms_81 = time_cuda(one_step_81, iters=5, warmup=1)
    del carry_81
    torch.cuda.empty_cache()
    out["step"] = {"ms_per_frame": step_ms, "host_ms_per_frame": host_ms,
                   "busy_ms_per_frame": prof["busy_ms"], "busy_share": prof["busy_ms"] / host_ms,
                   "kernel_launches_per_frame": prof["launches"], "split_device_ms": split,
                   "mesh_8x1_ms_per_frame": ms_81, "peak_GiB": peak}
    log(f"[16] config 5 sharded step, {SHARD_PATCHES} x 2 x {n}^2 bf16 on a {mesh.shape} mesh of "
        f"the card: {step_ms:.4f} ms/frame (CUDA events, best of 3 x 5), host clock "
        f"{host_ms:.4f} over 5 steps ending in a synchronize; device time by span (torch.profiler), "
        f"ms: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f"; the same state on an (8, 1) mesh ({SHARD_PATCHES} K4 steps) {ms_81:.4f} ms; peak "
        f"{peak:.3f} GiB above the resident {base / 2 ** 30:.3f} GiB; card {card}")
    return out


def scene_session(torch, T, dev, warm: bool = True):
    """The reference scene: 3 default cascades at 1024^2 with bf16 maps,
    SCENE["warmup"] updates (none for a session about to be restored), and
    the spray session (not yet started)."""
    from godotoceanwaves_tpu_torch.models.viewport import SpraySession
    ocean = T.Ocean(map_size=SCENE["map_size"], map_dtype=SCENE["map_dtype"],
                    updates_per_second=0, device=dev)
    for _ in range(SCENE["warmup"] if warm else 0):
        ocean.update(SCENE["dt"])
    return ocean, SpraySession(num_particles=SCENE["particles"], device=dev)


def scene_renderer(width: int, height: int, **kw):
    from godotoceanwaves_tpu_torch.models.viewport import RENDER_TIERS, SceneRenderer
    return SceneRenderer(width, height, mesh_quality="high", environment=True,
                         **RENDER_TIERS["interactive"], **kw)


def scene_frame(ocean, spray, renderer, cam, with_spray: bool = True):
    """One tick of the frame loop: update, spray advance, render (uint8)."""
    maps = ocean.update(SCENE["dt"])
    scales = ocean.params.map_scales()
    attrs = spray.advance(maps, scales, SCENE["dt"]) if with_spray else None
    img = renderer.render(maps, scales, ocean.water_color, ocean.foam_color, cam, SCENE_PITCH,
                          SCENE_YAW, spray_attrs=attrs)
    return img, maps, attrs


def clone_maps(maps):
    return maps.displacement.clone(), maps.normal.clone()


def phase_scene(torch, T, dev) -> dict:
    """Phase 18: the scene frame loop on the card, its checks."""
    from godotoceanwaves_tpu_torch.models import geometry, shading
    from godotoceanwaves_tpu_torch.models.viewport import (FramePipeline, make_batched_step,
                                                           ycbcr_to_rgb, yuv420_to_ycbcr)
    out = {}
    width, height = SCENE_SIZES[0]
    ocean, spray = scene_session(torch, T, dev)
    renderer = scene_renderer(width, height)
    cam = torch.tensor(CAM0, device=dev)
    pipe = FramePipeline()
    frames, visible, unbroken, snap = [], [], [], None
    n = SCENE["frames"]
    torch.cuda.synchronize()
    reset_counts()
    for i in range(n):
        img, maps, attrs = scene_frame(ocean, spray, renderer, cam)
        visible.append(attrs["visible"].sum())
        if snap is not None and len(unbroken) < SCENE["resumed"]:
            unbroken.append((clone_maps(maps), {k: v.clone() for k, v in attrs.items()},
                             ocean.state.foam.clone()))
        if i + 1 == SCENE["checkpoint_at"]:
            snap = (ocean.checkpoint(), spray.checkpoint())
        host = pipe.push(img)
        if host is not None:
            frames.append(host)
    frames.append(pipe.flush())
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[18] scene loop: {SCENE['warmup']} warm-up updates, then {n} frames of update + "
        f"spray advance ({SCENE['particles']} particles) + {width}x{height} render through "
        f"FramePipeline -> launches {counts}")
    check(counts == only(K1=2 * n, K5=n, splat=n, fan=n, spray=n),
          f"expected {2 * n} K1 (2 an update), {n} K5, {n} splat chains, {n} fan selects "
          f"and {n} spray steps (1 a frame), counted {counts}")
    check(len(frames) == n and all(f.shape == (height, width, 3) and f.dtype == np.uint8
                                   for f in frames), "the pipeline lost or reshaped a frame")
    vis = torch.stack(visible).cpu().numpy()
    log(f"[18] visible particles a frame: min {int(vis.min())}, mean {vis.mean():.1f}, max "
        f"{int(vis.max())} of {SCENE['particles']}; by frame {[int(v) for v in vis]}")
    moved = float(np.mean([np.abs(frames[i].astype(np.int16) - frames[i - 1]).mean()
                           for i in range(1, n)]))
    means = [float(f.mean()) for f in frames]
    maps = ocean.maps
    scales = ocean.params.map_scales()
    hit = geometry.render_ocean_geometry(
        maps, scales, "high", width=width, height=height, camera_pos=cam, pitch_deg=SCENE_PITCH,
        yaw_deg=SCENE_YAW, march_steps=renderer.march_steps, bisect_steps=renderer.bisect_steps,
        _debug_stage="march", **renderer.render_kwargs)[..., 1]
    sky = 1.0 - float(hit.mean())
    log(f"[18] frames: uint8 {frames[0].shape}, mean {min(means):.1f}..{max(means):.1f}, "
        f"mean |frame - previous| {moved:.3f} uint8 steps, sky share {sky:.4f} (0.05 .. 0.6)")
    check(0.05 <= sky <= 0.6, f"implausible sky share {sky}")
    check(20.0 <= min(means) and max(means) <= 235.0, "frames implausibly dark or bright")
    check(moved > 0.05, "the frames do not change: the loop is not animating")
    out.update(launches=counts, visible_by_frame=[int(v) for v in vis],
               visible_mean=float(vis.mean()), sky_share=sky, frame_change=moved)

    # the spray composite on the card vs the CPU, every particle visible and
    # at least 0.5 m across (a particle that never activated has scale <= 0)
    img = renderer._scene(maps, scales, tuple(map(float, ocean.water_color)),
                          tuple(map(float, ocean.foam_color)), cam, SCENE_PITCH, SCENE_YAW, 70.0)
    attrs = dict(spray.advance(maps, scales, SCENE["dt"]))
    attrs["visible"] = torch.ones_like(attrs["visible"])
    attrs["scale"] = attrs["scale"].abs().clamp_min(0.5)
    args = (img, attrs["position"], attrs["scale"], attrs["dissolve"], attrs["visible"])
    kw = dict(camera_pos=CAM0, pitch_deg=SCENE_PITCH, yaw_deg=SCENE_YAW,
              foam_color=tuple(map(float, ocean.foam_color)))
    got = shading.splat_spray(*args, custom_z=attrs["custom_z"], **kw)
    t0 = time.perf_counter()
    want = shading.splat_spray(*(a.cpu() for a in args), custom_z=attrs["custom_z"].cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    e_splat = max_abs(got, want)
    changed = max_abs(want, img.cpu())
    log(f"[18] splat, all {SCENE['particles']} particles visible (>= 0.5 m), {width}x{height}: card vs CPU "
        f"max |delta| {e_splat:.3e} (<= {TOL_SPLAT:g}); the splat moves the frame by up to "
        f"{changed:.3f}; the CPU took {cpu_s:.1f} s")
    check(e_splat <= TOL_SPLAT, "the splat on the card disagrees with the CPU")
    check(changed > 0.05, "the all-visible splat left the frame unchanged")
    out["splat_max_abs_err"] = e_splat

    # restore at frame checkpoint_at into fresh objects, then resume
    ocean_r, spray_r = scene_session(torch, T, dev, warm=False)
    ocean_r.restore(snap[0])
    spray_r.restore(snap[1])
    e_foam = e_disp = 0.0
    bit_equal = True
    for (disp, _), attrs_u, foam_u in unbroken:
        _, maps_r, attrs_r = scene_frame(ocean_r, spray_r, renderer, cam)
        e_disp = max(e_disp, max_abs(maps_r.displacement, disp))
        e_foam = max(e_foam, max_abs(ocean_r.state.foam, foam_u))
        bit_equal &= all(torch.equal(attrs_r[k], attrs_u[k]) for k in attrs_u)
    log(f"[18] restored at frame {SCENE['checkpoint_at']} into a fresh Ocean and SpraySession, "
        f"{len(unbroken)} frames on: spray attrs bit-equal {bit_equal}; displacement max "
        f"|delta| {e_disp:.3e} (<= {TOL_RESTORE_DISP:g}), foam {e_foam:.3e} "
        f"(<= {TOL_RESTORE_FOAM:g})")
    check(len(unbroken) == SCENE["resumed"] and bit_equal, "restored spray is not bit-equal")
    check(e_disp <= TOL_RESTORE_DISP and e_foam <= TOL_RESTORE_FOAM,
          "restored maps drift from the unbroken run")
    out.update(restore_spray_bit_equal=bit_equal, restore_disp_err=e_disp,
               restore_foam_err=e_foam)

    # K-frame batched step vs the sequential loop, from one snapshot
    k, total = SCENE["batch"], SCENE["batch_frames"]
    seq_o, seq_s = scene_session(torch, T, dev, warm=False)
    bat_o, bat_s = scene_session(torch, T, dev, warm=False)
    for o, s in ((seq_o, seq_s), (bat_o, bat_s)):
        o.restore(snap[0])
        s.restore(snap[1])
    seq = [scene_frame(seq_o, seq_s, renderer, cam)[0] for _ in range(total)]
    sp_params, sp_state = bat_s.ensure_init()
    fn = make_batched_step(renderer, bat_o.config, sp_params, k)
    state, clock, bat = bat_o.state, bat_s.clock, []
    reset_counts()
    for _ in range(total // k):
        state, sp_state, stack, _ = fn(state, bat_o.params, sp_state, clock, bat_o.water_color,
                                       bat_o.foam_color, cam, SCENE_PITCH, SCENE_YAW, 70.0,
                                       SCENE["dt"])
        clock += SCENE["dt"] * k
        bat.extend(stack)
    torch.cuda.synchronize()
    bcounts = read_counts()
    diff = (torch.stack(bat).short() - torch.stack(seq).short()).abs()
    equal = float((diff == 0).float().mean())
    log(f"[18] make_batched_step(k={k}) over {total} frames vs the sequential loop: max "
        f"{int(diff.max())} uint8 steps (<= {TOL_BATCH_STEP}), {equal:.5f} of pixels equal "
        f"(>= {BATCH_EQUAL}); launches {bcounts}")
    check(int(diff.max()) <= TOL_BATCH_STEP and equal >= BATCH_EQUAL,
          "batched frames disagree with the sequential loop")
    check(bcounts == only(K1=2 * total, K5=total, splat=total, fan=total, spray=total),
          f"expected {2 * total} K1 (a row and a column pass a frame, from one multi-frame "
          f"call a batch), {total} K5, {total} splat chains, {total} fan selects and {total} "
          f"spray steps")
    out.update(batched_max_step=int(diff.max()), batched_equal_share=equal,
               batched_launches=bcounts)
    del seq_o, seq_s, bat_o, bat_s, ocean_r, spray_r

    # the YUV420 wire at 1280x720
    w2, h2 = SCENE_SIZES[1]
    rgb = scene_renderer(w2, h2).render(maps, scales, ocean.water_color, ocean.foam_color, cam,
                                        SCENE_PITCH, SCENE_YAW).cpu().numpy()
    flat = scene_renderer(w2, h2, transfer="yuv420").render(
        maps, scales, ocean.water_color, ocean.foam_color, cam, SCENE_PITCH, SCENE_YAW)
    wire = flat.cpu().numpy()
    back = ycbcr_to_rgb(yuv420_to_ycbcr(wire, h2, w2))
    yuv_err = float(np.abs(back.astype(np.int16) - rgb).mean())
    log(f"[18] YUV420 wire at {w2}x{h2}: {wire.size} bytes = {wire.size / (w2 * h2):.2f} B/px "
        f"(RGB {rgb.size / (w2 * h2):.0f}); round trip mean |delta| {yuv_err:.3f} uint8 steps "
        f"(<= {TOL_YUV_MEAN:g})")
    check(wire.dtype == np.uint8 and wire.size * 2 == w2 * h2 * 3, "the YUV420 wire is not 1.5 B/px")
    check(yuv_err <= TOL_YUV_MEAN, "the YUV420 round trip is far from the RGB frame")
    out.update(yuv_bytes_per_px=wire.size / (w2 * h2), yuv_mean_err=yuv_err)

    # one frame under sync-debug "error": the loop reads nothing back
    scene_frame(ocean, spray, renderer, cam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, _, _ = scene_frame(ocean, spray, renderer, cam)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[18] one update + spray advance + render under torch.cuda.set_sync_debug_mode('error'):"
        " no host sync")
    out["sync_free"] = True

    # the viewers: 3 LiveViewer frames, one demo_torch.py run
    import io
    from godotoceanwaves_tpu_torch.utils.live import LiveViewer
    script = iter(["+", "\t", ""])
    text = io.StringIO()
    viewer = LiveViewer(ocean, input_fn=lambda: next(script, ""), output=text, spray=True)
    viewer.run(max_frames=3)
    check(viewer._spray.started and text.getvalue().count("\x1b[38;2;") > 1000,
          "LiveViewer drew no frame")
    log(f"[18] LiveViewer: 3 frames ({viewer.cols}x{viewer.rows * 2} px, spray on), "
        f"{len(text.getvalue())} characters, p50 {viewer.stats.summary()['ms_p50']:.1f} ms/frame")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "demo_torch.py"), "--frames", "3",
                           "--spray"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    log(f"[18] demo_torch.py --frames 3 --spray: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; {proc.stdout.strip().splitlines()[-1:]}")
    check(proc.returncode == 0 and "frames: 3 x (540, 960, 3) uint8 on cuda" in proc.stdout,
          f"demo_torch.py failed: {proc.stderr[-2000:]}")
    out["ocean"], out["spray"], out["cam"] = ocean, spray, cam
    return out


def host_ms(torch, call, iters: int) -> float:
    """Host clock over `iters` calls ending in a synchronize, ms a call."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def events_and_host(torch, call, iters: int = SCENE_TIMING_ITERS) -> dict:
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    return {"ms": time_cuda(call, iters=iters, warmup=2), "host_ms": host_ms(torch, call, iters)}


def in_turns(torch, calls: dict) -> dict:
    """`events_and_host` of two calls in turns (a, b, b, a): each one's best
    and every pass, so a difference stands beside the host's spread."""
    a, b = calls
    passes = {a: [], b: []}
    for name in (a, b, b, a):
        passes[name].append(events_and_host(torch, calls[name]))
    return {name: {"ms": min(r["ms"] for r in runs), "host_ms": min(r["host_ms"] for r in runs),
                   "ms_all": [r["ms"] for r in runs], "host_ms_all": [r["host_ms"] for r in runs]}
            for name, runs in passes.items()}


def scene_json(res: dict, timing: dict, card: str) -> dict:
    """The `scene` line: phase 18's checks and times, with the card."""
    checks = {k: v for k, v in res.items() if k not in ("ocean", "spray", "cam")}
    return {"scene": dict(card=card, map_size=SCENE["map_size"], cascades=3,
                          map_dtype=SCENE["map_dtype"], particles=SCENE["particles"],
                          frames=SCENE["frames"], tier="interactive", **checks, **timing)}


def phase_scene_timing(torch, dev, res: dict, card: str) -> dict:
    """Phase 18 timing at each SCENE_SIZES: update, spray advance, the
    render without and with spray (in turns) and the splat alone, the whole
    loop through FramePipeline and fetching after each render (in turns);
    launches a frame and the device's busy share (torch.profiler), peak
    device memory."""
    from godotoceanwaves_tpu_torch.models import shading
    from godotoceanwaves_tpu_torch.models.viewport import FramePipeline
    ocean, spray, cam = res["ocean"], res["spray"], res["cam"]
    dt = SCENE["dt"]
    scales = ocean.params.map_scales()
    out = {"update": events_and_host(torch, lambda: ocean.update(dt))}
    maps = ocean.maps
    out["advance"] = events_and_host(torch, lambda: spray.advance(maps, scales, dt))
    attrs = spray.advance(maps, scales, dt)
    log(f"[18] update {out['update']['ms']:.3f} ms (events), {out['update']['host_ms']:.3f} "
        f"(host clock); spray advance ({SCENE['particles']}) {out['advance']['ms']:.3f} / "
        f"{out['advance']['host_ms']:.3f}; card {card}")
    wc, fc = ocean.water_color, ocean.foam_color
    for width, height in SCENE_SIZES:
        r = scene_renderer(width, height)
        leg = {}
        leg.update(in_turns(torch, {
            "render": lambda: r.render(maps, scales, wc, fc, cam, SCENE_PITCH, SCENE_YAW),
            "render_spray": lambda: r.render(maps, scales, wc, fc, cam, SCENE_PITCH, SCENE_YAW,
                                             spray_attrs=attrs)}))
        img = r._scene(maps, scales, tuple(map(float, wc)), tuple(map(float, fc)), cam,
                       SCENE_PITCH, SCENE_YAW, 70.0)
        splat = lambda: shading.splat_spray(img, attrs["position"], attrs["scale"],
                                            attrs["dissolve"], attrs["visible"], camera_pos=cam,
                                            pitch_deg=SCENE_PITCH, yaw_deg=SCENE_YAW,
                                            foam_color=tuple(map(float, fc)),
                                            custom_z=attrs["custom_z"])
        leg["splat"] = events_and_host(torch, splat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        splat()
        torch.cuda.synchronize()
        leg["splat_peak_GiB"] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        rows = SCENE["particles"] * len(shading._puff_lobes())
        leg["splat_gflop"] = 2.0 * rows * height * width / 1e9
        pipe = FramePipeline()
        leg.update(in_turns(torch, {
            "loop_pipelined": lambda: pipe.push(scene_frame(ocean, spray, r, cam)[0]),
            "loop_fetch": lambda: scene_frame(ocean, spray, r, cam)[0].cpu().numpy()}))
        pipe.flush()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        scene_frame(ocean, spray, r, cam)
        torch.cuda.synchronize()
        leg["frame_peak_GiB"] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        leg["resident_GiB"] = base / 2 ** 30
        prof = profile_frames(torch, lambda: scene_frame(ocean, spray, r, cam),
                              f"{width}x{height}", leg["loop_fetch"]["host_ms"], phase=18,
                              stem="scene_profile")
        leg["launches_per_frame"] = prof["launches"]
        leg["busy_ms"] = prof["busy_ms"]
        leg["busy_share"] = prof["busy_ms"] / leg["loop_fetch"]["host_ms"]
        try:
            a = torch.rand((rows, height), device=dev).to(torch.bfloat16)
            b = torch.rand((rows, width), device=dev).to(torch.bfloat16)
            leg["splat_product_fp32_ms"] = events_and_host(
                torch, lambda: a.float().T @ b.float())["ms"]
            leg["splat_product_bf16_out_fp32_ms"] = events_and_host(
                torch, lambda: torch.mm(a.T, b, out_dtype=torch.float32))["ms"]
        except (TypeError, RuntimeError) as exc:
            leg["splat_product_bf16_out_fp32_ms"] = None
            log(f"[18] torch.mm(out_dtype=float32) unavailable: {str(exc)[:200]}")
        out[f"{width}x{height}"] = leg
        fmt = lambda d: (f"{d['ms']:.3f} ms (events) / {d['host_ms']:.3f} (host clock)" +
                         (f" [passes {', '.join(f'{v:.2f}' for v in d['ms_all'])} / "
                          f"{', '.join(f'{v:.2f}' for v in d['host_ms_all'])}]"
                          if "ms_all" in d else ""))
        log(f"[18] {width}x{height}: render {fmt(leg['render'])}; with spray "
            f"{fmt(leg['render_spray'])}; splat alone {fmt(leg['splat'])} "
            f"({leg['splat_gflop']:.1f} GFLOP, peak {leg['splat_peak_GiB']:.3f} GiB above the "
            f"resident); loop through FramePipeline {fmt(leg['loop_pipelined'])}; loop fetching "
            f"after each render {fmt(leg['loop_fetch'])}; frame peak {leg['frame_peak_GiB']:.3f} "
            f"GiB above {leg['resident_GiB']:.3f} resident; {leg['launches_per_frame']:.0f} "
            f"launches a frame, device busy {leg['busy_ms']:.3f} ms = {leg['busy_share']:.1%} of "
            f"the fetching loop's frame; the splat's product alone: fp32 "
            f"{leg.get('splat_product_fp32_ms') or 0:.3f} ms, bf16 -> fp32 "
            f"{leg['splat_product_bf16_out_fp32_ms'] or 0:.3f} ms; card {card}")
    return out


def web_get(port: int, path: str, timeout: float = 60.0) -> tuple:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.headers.get("Content-Type"), r.read()


def web_state(port: int) -> dict:
    return json.loads(web_get(port, "/state")[1])


def web_post(port: int, body: dict) -> None:
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/set", data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        check(r.status == 200, f"POST /set {body} answered {r.status}")


def web_wait(port: int, cond, limit: float, what: str) -> dict:
    deadline = time.perf_counter() + limit
    state = web_state(port)
    while not cond(state):
        check(time.perf_counter() < deadline, f"{what}: not within {limit:g} s")
        time.sleep(0.05)
        state = web_state(port)
    return state


def served_rate(port: int) -> tuple[float, dict]:
    """Frames published per second over WEB_WINDOW seconds, from the
    /state frame counter."""
    s0, t0 = web_state(port), time.perf_counter()
    time.sleep(WEB_WINDOW)
    s1, t1 = web_state(port), time.perf_counter()
    return (s1["frame"] - s0["frame"]) / (t1 - t0), s1


def web_frame(viewer) -> np.ndarray:
    """One frame of the viewer's live renderer from its ocean's maps, in its
    wire format, on the host (the viewer stopped)."""
    o = viewer.ocean
    pos, pitch, yaw, fov = viewer._camera_args()
    scales = o.params.map_scales()
    attrs = viewer._spray.advance(o.maps, scales, 1 / WEB["fps"])
    return viewer._viewport.render(o.maps, scales, o.water_color, o.foam_color, pos, pitch, yaw,
                                   fov=fov, spray_attrs=attrs).cpu().numpy()


def encode_times(viewer, host: np.ndarray, jpeg: bool) -> dict:
    """`_frame_bytes` alone on a real frame, as `_publish` calls it (the
    YUV420 unpack included), through the standard-library PNG and, where
    PIL writes it, JPEG: mean ms over ENCODE_REPS and the body's bytes."""
    from godotoceanwaves_tpu_torch.models.viewport import yuv420_to_ycbcr
    from godotoceanwaves_tpu_torch.utils.webviewer import _frame_bytes

    def encode(encoder):
        if viewer._viewport.transfer == "yuv420":
            return _frame_bytes(yuv420_to_ycbcr(host, viewer.height, viewer.width),
                                mode="YCbCr", encoder=encoder)
        return _frame_bytes(host, encoder=encoder)
    out = {}
    for encoder in ("png", "jpeg") if jpeg else ("png",):
        body, _ = encode(encoder)
        t0 = time.perf_counter()
        for _ in range(ENCODE_REPS):
            encode(encoder)
        out[f"{encoder}_encode_ms"] = (time.perf_counter() - t0) / ENCODE_REPS * 1e3
        out[f"{encoder}_bytes"] = len(body)
    return out


def png_sweep(rgb: np.ndarray, tag: str) -> dict:
    """The standard-library PNG's zlib level and row filter on a real
    frame: mean ms over ENCODE_REPS and bytes of each."""
    from godotoceanwaves_tpu_torch.utils.webviewer import png_bytes
    out = {}
    for level in PNG_LEVELS:
        for row_filter in PNG_FILTERS:
            body = png_bytes(rgb, level, row_filter)
            t0 = time.perf_counter()
            for _ in range(ENCODE_REPS):
                png_bytes(rgb, level, row_filter)
            ms = (time.perf_counter() - t0) / ENCODE_REPS * 1e3
            out[f"level {level} filter {row_filter}"] = {"ms": ms, "bytes": len(body)}
    log(f"[19] standard-library PNG of a real {tag} frame ({rgb.nbytes} raw bytes), ms / bytes: " +
        "; ".join(f"{k} {v['ms']:.2f} / {v['bytes']}" for k, v in out.items()))
    return out


def web_viewer(T, dev, **kw):
    from godotoceanwaves_tpu_torch.utils.webviewer import WebViewer
    ocean = T.Ocean(map_size=WEB["map_size"], map_dtype=WEB["map_dtype"], updates_per_second=0,
                    device=dev)
    args = dict(fps=WEB["fps"], width=WEB["width"], height=WEB["height"], spray=True,
                spray_particles=WEB["particles"])
    return WebViewer(ocean, **{**args, **kw})


def web_edits(port: int, viewer) -> dict:
    """Every panel edit while serving, each checked in /state."""
    from godotoceanwaves_tpu_torch.utils.webviewer import PARAM_RANGES
    for name, (lo, hi, step) in PARAM_RANGES.items():
        value = lo + round((hi - lo) * 0.3 / step) * step
        web_post(port, {"cascade": 0, "name": name, "value": value})
        got = web_state(port)["cascades"][0][name]
        check(abs(got - value) <= 1e-4 * max(1.0, abs(value)),
              f"/set {name}={value}: /state reads {got}")
    for want in (4, 3):
        web_post(port, {"name": "num_cascades", "value": want})
        check(len(web_state(port)["cascades"]) == want, f"num_cascades {want} not in /state")
    web_post(port, {"name": "water_color", "value": [0.1, 0.3, 0.6]})
    got = web_state(port)["water_color"]
    check(np.allclose(got, np.array([0.1, 0.3, 0.6]) ** 2.2, atol=1e-5), f"water_color {got}")
    cam0 = web_state(port)["camera"]
    web_post(port, {"name": "camera_move", "value": [1, 0, 0, 0, 0.5]})
    check(np.linalg.norm(np.subtract(web_state(port)["camera"], cam0)) > 1.0, "camera_move")
    web_post(port, {"name": "fov", "value": 95})
    check(web_state(port)["fov"] == 95.0, "fov")
    for on in (False, True):
        web_post(port, {"name": "spray", "value": on})
        check(web_state(port)["spray"] is on, f"spray {on}")
    f0 = web_state(port)["frame"]
    state = web_wait(port, lambda s: s["frame"] >= f0 + 3, WEB_SWAP_LIMIT,
                     "frames after the edits")
    log(f"[19] edits while serving: each of the {len(PARAM_RANGES)} cascade fields, "
        f"num_cascades 3 -> 4 -> 3, water_color, camera_move, fov, spray off and on, each read "
        f"back from /state; frames flow on (frame {state['frame']})")
    return {"edits": len(PARAM_RANGES) + 7}


def web_swaps(port: int) -> dict:
    """map_size 1024 -> 512 -> 1024 and render_tier interactive ->
    performance -> interactive while serving: /state latency, swap time,
    frames served during the swap."""
    out = {}
    for name, value in (("map_size", 512), ("map_size", WEB["map_size"]),
                        ("render_tier", "performance"), ("render_tier", "interactive")):
        busy = "resizing" if name == "map_size" else "retiering"
        f0 = web_state(port)["frame"]
        t0 = time.perf_counter()
        web_post(port, {"name": name, "value": value})
        lat, state = [], None
        while state is None or state[name] != value or state[busy]:
            check(time.perf_counter() - t0 < WEB_SWAP_LIMIT,
                  f"{name} -> {value}: the swap did not end within {WEB_SWAP_LIMIT:g} s")
            time.sleep(0.05)
            t = time.perf_counter()
            state = web_state(port)
            lat.append(time.perf_counter() - t)
        swap_s = time.perf_counter() - t0
        during = state["frame"] - f0
        after = web_wait(port, lambda s: s["frame"] > state["frame"], WEB_SWAP_LIMIT,
                         f"frames after {name} -> {value}")
        key = f"{name} -> {value}"
        out[key] = {"swap_s": swap_s, "frames_during": during,
                    "state_p50_ms": float(np.median(lat)) * 1e3, "state_max_ms": max(lat) * 1e3}
        log(f"[19] {key}: swapped in {swap_s:.2f} s, {during} frames served meanwhile; /state "
            f"answered in {out[key]['state_p50_ms']:.1f} ms p50, {out[key]['state_max_ms']:.1f} "
            f"max over {len(lat)} polls; frame {after['frame']} after")
        check(during >= 1, f"{key}: no frame served during the swap")
        check(max(lat) < WEB_STATE_LIMIT, f"{key}: /state took {max(lat):.2f} s")
    return out


def web_checkpoint(T, dev, viewer) -> dict:
    """checkpoint() of the stopped viewer, restore() into a second viewer on
    a fresh Ocean: spray bit-equal, camera and clocks equal; the restored
    viewer serves."""
    import dataclasses
    snap = viewer.checkpoint()
    twin = web_viewer(T, dev, width=viewer.width, height=viewer.height,
                      render_scale=viewer.render_scale, transfer=viewer.transfer)
    twin.restore(snap)
    a, b = viewer._spray._state, twin._spray._state
    bit_equal = all(torch_equal(getattr(a, f.name), getattr(b, f.name))
                    for f in dataclasses.fields(a))
    # the position crosses as fp32, the form the renderer takes it in
    cam = (np.array_equal(np.float32(viewer.camera.position), twin.camera.position)
           and all(getattr(viewer.camera, k) == getattr(twin.camera, k)
                   for k in ("pitch", "yaw", "fov_deg", "speed")))
    clocks = (twin._spray.clock == viewer._spray.clock
              and twin.ocean._time == viewer.ocean._time
              and torch_equal(twin.ocean.state.time, viewer.ocean.state.time))
    port = twin.start(port=0)
    try:
        f = web_wait(port, lambda s: s["frame"] >= 2, WEB_SWAP_LIMIT, "the restored viewer")
    finally:
        twin.stop()
    log(f"[19] checkpoint of the stopped viewer restored into a fresh Ocean's viewer: spray state "
        f"bit-equal {bit_equal} (cycle {tuple(b.cycle.shape)}), camera equal {cam}, spray clock "
        f"and sim time equal {clocks}; the restored viewer served {f['frame']} frames")
    check(bit_equal and cam and clocks, "the restored viewer differs from the checkpointed one")
    return {"restore_spray_bit_equal": bit_equal, "restore_camera_equal": cam,
            "restore_clocks_equal": clocks}


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a.cpu(), b.cpu()))


def web_demo(jpeg: bool) -> dict:
    """`demo_torch.py --web --port <free port> --spray` in a subprocess: GET
    / and /frame.png (JPEG where PIL writes it, else PNG), then stop it."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "demo_torch.py"), "--web",
                             "--port", str(port), "--spray"], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        page = None
        while page is None:
            check(proc.poll() is None and time.perf_counter() - t0 < 300,
                  "demo_torch.py --web did not serve")
            try:
                page = web_get(port, "/", timeout=10)[1]
            except OSError:
                time.sleep(0.2)
        state = web_wait(port, lambda s: s["frame"] >= 2, 120, "demo_torch.py --web frames")
        mime, body = web_get(port, "/frame.png")
        took = time.perf_counter() - t0
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
    log(f"[19] demo_torch.py --web --port {port} --spray: page {len(page)} bytes, frame "
        f"{state['frame']} as {mime} ({len(body)} bytes, {state['map_size']}^2 maps) after "
        f"{took:.1f} s; stopped (rc {proc.returncode})")
    magic = b"\xff\xd8" if jpeg else b"\x89PNG\r\n\x1a\n"
    check(b"ocean panel" in page and body.startswith(magic)
          and mime == ("image/jpeg" if jpeg else "image/png"),
          f"demo_torch.py --web served no frame ({mime})")
    return {"demo_frames": state["frame"], "demo_mime": mime, "demo_s": took}


def phase_web(torch, T, dev, card: str) -> dict:
    """Phase 19: the browser viewer on the card."""
    from godotoceanwaves_tpu_torch.utils import webviewer
    jpeg_here = webviewer.jpeg_available
    out = {"jpeg_available": jpeg_here(), "rates": {}, "encode": {}}
    viewer, port, sweep_frames = None, None, {}
    try:
        for i, (tag, kw, batch, encoder) in enumerate(WEB_RATES):
            if i == 0 or WEB_RATES[i - 1][0] != tag:
                # a forced PNG stands where PIL is missing: "auto" resolves
                # the transfer and picks the encoder by `jpeg_available`
                webviewer.jpeg_available = (lambda: False) if encoder == "png" else jpeg_here
                viewer = web_viewer(T, dev, **kw)
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                port = viewer.start(port=0)
                state = web_wait(port, lambda s: s["frame"] >= WEB["first_frames"], 120,
                                 f"{tag}: first frames")
                first_s = time.perf_counter() - t0
                counts = read_counts()
                mime, body = web_get(port, "/frame.png")
                page = web_get(port, "/")[1]
                log(f"[19] WebViewer({WEB['map_size']}^2 {WEB['map_dtype']}, {viewer.width}x"
                    f"{viewer.height}, {tag}: {viewer._viewport.transfer} wire, spray "
                    f"{WEB['particles']}) on port {port}: frame {state['frame']} after "
                    f"{first_s:.2f} s; /frame.png {mime} {len(body)} bytes; / {len(page)} bytes; "
                    f"launches {counts}")
                n = state["frame"]
                check(counts["K1"] >= 2 * n and counts["K5"] >= n
                      and all(counts[k] == 0 for k in ("K2", "K3", "K4", "K6")),
                      f"{tag}: expected at least {2 * n} K1 and {n} K5 and nothing else, "
                      f"counted {counts}")
                png = encoder == "png" or not out["jpeg_available"]
                check(mime == ("image/png" if png else "image/jpeg"), f"/frame.png is {mime}")
                check(not png or body[:8] == b"\x89PNG\r\n\x1a\n", "/frame.png is not a PNG")
                check(b"ocean panel" in page, "/ did not serve the panel")
                out.setdefault("first", {})[tag] = {"first_frames_s": first_s,
                                                    "launches": counts, "mime": mime,
                                                    "wire": viewer._viewport.transfer}
            web_post(port, {"name": "frame_batch", "value": batch})
            time.sleep(1.0)               # the loop changes mode at its next tick
            reset_counts()
            rate, state = served_rate(port)
            counts = read_counts()
            key = f"{tag} frame_batch={batch}"
            out["rates"][key] = {"served_fps": rate, "loop_fps": state["fps"],
                                 "loop_ms_frame": state["ms_frame"], "launches": counts}
            log(f"[19] {key}: {rate:.2f} frames/s served over {WEB_WINDOW:g} s; loop "
                f"{state['fps']:.2f} fps, {state['ms_frame']:.2f} ms/frame; launches in the "
                f"window {counts}; card {card}")
            check(rate > 0 and counts["K1"] > 0 and counts["K5"] > 0,
                  f"{key}: no frames or no K1 / K5 launches")
            if i + 1 < len(WEB_RATES) and WEB_RATES[i + 1][0] == tag:
                continue
            web_post(port, {"name": "frame_batch", "value": 1})
            if i == 1:                    # the first viewer: edits and swaps while serving
                out.update(web_edits(port, viewer))
                out["swaps"] = web_swaps(port)
            viewer.stop()
            host = web_frame(viewer)
            enc = encode_times(viewer, host, out["jpeg_available"])
            out["encode"][tag] = enc
            log(f"[19] {tag}: one {viewer._viewport.transfer} frame's _frame_bytes: " +
                "; ".join(f"{k} {v:.2f}" if k.endswith("ms") else f"{k} {v}"
                          for k, v in enc.items()))
            if viewer._viewport.transfer == "rgb":
                sweep_frames[f"{viewer.width}x{viewer.height}"] = host
            if kw == WEB_720P and encoder == "png":
                out.update(web_checkpoint(T, dev, viewer))
            del viewer
            torch.cuda.empty_cache()
    finally:
        webviewer.jpeg_available = jpeg_here
    out["png"] = {tag: png_sweep(frame, tag) for tag, frame in sweep_frames.items()}
    out.update(web_demo(out["jpeg_available"]))
    out["card"] = card
    return out


def config5_multipatch(T, par, dev):
    """BASELINE config 5 at full width (phase 15's): 8 patches x the dual
    wind/swell cascades at 2048^2, bf16 maps; (params, config, fp32 config)."""
    params = par.multipatch_params(T.models.dual_wind_swell_cascades(device=dev), SHARD_PATCHES)
    return (params, T.SimConfig(map_size=STRIP_SIZE, map_dtype="bfloat16"),
            T.SimConfig(map_size=STRIP_SIZE))


def multihost_nccl_leg() -> dict:
    """Phase 20 (a), in one NCCL worker: config 5 at full width on the (4, 2)
    mesh of `make_multihost_mesh` over 8 positions of the card, against one
    controller driving the same positions (phase 15's run)."""
    import torch
    import godotoceanwaves_tpu_torch as T
    from godotoceanwaves_tpu_torch import parallel as par
    from godotoceanwaves_tpu_torch.parallel import multihost
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    dev = multihost.local_device()
    params, cfg, cfg32 = config5_multipatch(T, par, dev)
    devices = multihost.global_devices([dev] * SHARD_PATCHES)
    mesh = par.make_multihost_mesh(rows=SHARD_ROWS_C5, devices=devices)
    check(mesh.collective and mesh.shape == {"patch": SHARD_PATCHES // SHARD_ROWS_C5,
                                             "rows": SHARD_ROWS_C5}, f"mesh {mesh}")
    out = {"backend": torch.distributed.get_backend(), "world": multihost.process_count(),
           "mesh": mesh.shape}
    step = par.make_multichip_step(mesh, cfg)
    state = par.make_multichip_init(mesh, cfg)(params)
    one = par.build_mesh([dev] * SHARD_PATCHES, rows=SHARD_ROWS_C5)
    ref_state = par.sharding.Sharded(one, [list(row) for row in state.blocks])   # read only
    reset_counts()
    for _ in range(CONFIG5_UPDATES):
        state, maps = step(state, params, 0.02)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[20a] config 5, {SHARD_PATCHES} x 2 x {STRIP_SIZE}^2 bf16 on {mesh.shape} over "
        f"{out['backend']} (world {out['world']}), {CONFIG5_UPDATES} updates -> launches {counts}")
    check(counts == only(K3=2 * SHARD_PATCHES * CONFIG5_UPDATES),
          f"expected {2 * SHARD_PATCHES * CONFIG5_UPDATES} K3 launches and no other, counted "
          f"{counts}")
    out["launches_K3"] = counts["K3"]

    one_step = par.make_multichip_step(one, cfg)
    for _ in range(CONFIG5_UPDATES):
        ref_state, ref_maps = one_step(ref_state, params, 0.02)
    got, want = maps.gather(dev), ref_maps.gather(dev)     # foam is the normal map's 4th channel
    out["max_abs_vs_one_controller"] = max(max_abs(got.displacement, want.displacement),
                                           max_abs(got.normal, want.normal))
    log(f"[20a] maps and foam after {CONFIG5_UPDATES} updates vs one controller on the same "
        f"positions (phase 15's run): max abs {out['max_abs_vs_one_controller']:.3e} (== 0)")
    check(out["max_abs_vs_one_controller"] == 0.0, "the NCCL mesh differs from one controller")
    del got, want
    t0 = time.perf_counter()
    host = par.gather_maps(maps)
    out["gather_maps_s"] = time.perf_counter() - t0
    host_ref = par.gather_maps(ref_maps)
    out["gather_maps_equal"] = (torch.equal(host.displacement, host_ref.displacement)
                                and torch.equal(host.normal, host_ref.normal))
    log(f"[20a] gather_maps through {out['backend']} ({out['gather_maps_s']:.2f} s, "
        f"{tuple(host.displacement.shape)} {host.displacement.dtype}) equals one controller's "
        f"Sharded.gather: {out['gather_maps_equal']}")
    check(out["gather_maps_equal"], "gather_maps through the process group differs")
    del host, host_ref, ref_maps
    torch.cuda.empty_cache()

    def frame():
        carry[0], _ = step(carry[0], params, 0.02)

    def frame_one():
        carry_one[0], _ = one_step(carry_one[0], params, 0.02)
    carry, carry_one = [state], [ref_state]
    ms, one_ms, t = turns(time_cuda, frame_one, frame, iters=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        frame()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    prof = profile_frames(torch, frame, f"multihost_nccl {mesh.shape}", host_ms, phase=20,
                          stem="multihost_profile", ranges=SHARDED_SPANS)
    out.update(ms_per_frame=ms, one_controller_ms_per_frame=one_ms, turns_ms=t,
               host_ms_per_frame=host_ms, busy_ms_per_frame=prof["busy_ms"],
               split_device_ms={k.split("/")[1]: v for k, v in prof["spans_ms"].items()})
    log(f"[20a] the (4, 2) step over {out['backend']}: {ms:.4f} ms/frame (CUDA events, turns "
        f"{[round(v, 4) for v in t]}), one controller {one_ms:.4f}; host clock {host_ms:.4f}; "
        "device time by span, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                                 out["split_device_ms"].items()))
    state = carry[0]
    del carry_one, ref_state, one_step
    torch.cuda.empty_cache()

    ckpt = os.path.join(ROOT, "build", "multihost_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    par.save_sharded(ckpt, state)
    mesh_b = par.make_multihost_mesh(rows=2 * SHARD_ROWS_C5, devices=devices)
    restored = par.restore_sharded(ckpt, mesh_b, state)
    out["checkpoint_s"] = time.perf_counter() - t0
    state32, maps32 = par.make_multichip_step(mesh, cfg32)(state, params, 0.02)
    cont, cont_maps = par.make_multichip_step(mesh_b, cfg32)(restored, params, 0.02)
    out["restore_foam_max_abs"] = max_abs(cont.gather(dev).foam, state32.gather(dev).foam)
    out["restore_disp_max_abs"] = max_abs(cont_maps.gather(dev).displacement,
                                          maps32.gather(dev).displacement)
    log(f"[20a] checkpoint on {mesh.shape}, restored on {mesh_b.shape} "
        f"({out['checkpoint_s']:.2f} s), one frame on: foam max abs "
        f"{out['restore_foam_max_abs']:.3e} (<= {TOL_RESTORE_FOAM:g}), displacement "
        f"{out['restore_disp_max_abs']:.3e} (<= {TOL_RESTORE_DISP:g}) vs the unbroken run")
    check(out["restore_foam_max_abs"] <= TOL_RESTORE_FOAM
          and out["restore_disp_max_abs"] <= TOL_RESTORE_DISP,
          "the restored run differs from the unbroken run")
    del restored, cont, cont_maps, state32, maps32
    mesh_81 = par.make_multihost_mesh(rows=1, devices=devices)
    state_81 = par.restore_sharded(ckpt, mesh_81, state)
    shutil.rmtree(ckpt)
    reset_counts()
    par.make_multichip_step(mesh_81, cfg)(state_81, params, 0.02)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[20a] the same state restored on {mesh_81.shape}: one step -> launches {counts}")
    check(counts == only(K4=2 * SHARD_PATCHES),
          f"an (8, 1) step should be {SHARD_PATCHES} K4 steps, counted {counts}")
    out["mesh_8x1_launches_K4"] = counts["K4"]
    return out


def gloo_cuda_probe(dev) -> dict:
    """Whether gloo takes CUDA tensors in `all_to_all_single` and the list
    `all_gather` on this torch (each rank sends its rank)."""
    import torch
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    x = torch.full((world,), float(rank), device=dev)
    try:
        got = torch.empty_like(x)
        dist.all_to_all_single(got, x)
        out["all_to_all_single"] = got.tolist() == [float(r) for r in range(world)]
    except RuntimeError as e:
        out["all_to_all_single"] = f"refused: {str(e).splitlines()[0]}"
    try:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        out["all_gather"] = [float(p[0]) for p in parts] == [float(r) for r in range(world)]
    except RuntimeError as e:
        out["all_gather"] = f"refused: {str(e).splitlines()[0]}"
    return out


def multihost_gloo_leg() -> dict:
    """Phase 20 (b), in two gloo workers sharing the card: the (4, 2) mesh
    whose rows groups pair process 0 with process 1, so every exchange
    crosses processes; CUDA positions at config 5's full width where gloo
    takes CUDA tensors, else CPU positions at MULTIHOST_CPU_SIZE^2. Bit-equal
    to one controller driving the same positions."""
    import torch
    import godotoceanwaves_tpu_torch as T
    from godotoceanwaves_tpu_torch import parallel as par
    from godotoceanwaves_tpu_torch.parallel import multihost
    dev = multihost.local_device()
    probe = gloo_cuda_probe(dev)
    cuda_ok = probe["all_to_all_single"] is True and probe["all_gather"] is True
    pos = dev if cuda_ok else torch.device("cpu")
    params, cfg, _ = config5_multipatch(T, par, pos)
    if not cuda_ok:
        cfg = T.SimConfig(map_size=MULTIHOST_CPU_SIZE, map_dtype="bfloat16")
    per = SHARD_PATCHES // multihost.process_count()
    every = multihost.global_devices([pos] * per)
    paired = [d for k in range(per) for d in every[k::per]]     # (0, 1), (0, 1), ...
    mesh = par.build_mesh(paired, rows=SHARD_ROWS_C5)
    check(all(row == [0, 1] for row in mesh.processes.tolist()), f"mesh {mesh}")
    step = par.make_multichip_step(mesh, cfg)
    state = par.make_multichip_init(mesh, cfg)(params)
    times = []
    for _ in range(MULTIHOST_GLOO_FRAMES):
        t0 = time.perf_counter()
        state, maps = step(state, params, 0.02)
        if pos.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    got = maps.gather(pos)                      # foam is the normal map's 4th channel
    out = {"backend": torch.distributed.get_backend(), "world": multihost.process_count(),
           "mesh": mesh.shape, "owners": mesh.processes.tolist(), "probe": probe,
           "positions": str(pos), "map_size": cfg.map_size, "frames": MULTIHOST_GLOO_FRAMES,
           "host_ms_per_frame": times}
    if multihost.process_index() == 0:
        one = par.build_mesh([pos] * SHARD_PATCHES, rows=SHARD_ROWS_C5)
        one_step = par.make_multichip_step(one, cfg)
        ref_state = par.make_multichip_init(one, cfg)(params)
        for _ in range(MULTIHOST_GLOO_FRAMES):
            ref_state, ref_maps = one_step(ref_state, params, 0.02)
        want = ref_maps.gather(pos)
        out["max_abs_vs_one_controller"] = max(max_abs(got.displacement, want.displacement),
                                               max_abs(got.normal, want.normal))
        check(out["max_abs_vs_one_controller"] == 0.0,
              f"the gloo mesh differs from one controller by {out['max_abs_vs_one_controller']}")
    return out


def multihost_example(proc, t0: float) -> dict:
    """The end of `examples/multichip_torch.py` on the card, started at t0
    in a fresh interpreter (`proc`)."""
    stdout, stderr = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"examples/multichip_torch.py failed:\n{stderr[-3000:]}")
    lines = stdout.strip().splitlines()
    for line in lines:
        log(f"[20c] examples/multichip_torch.py: {line}")
    check(any(line.startswith("mesh: {'patch': 2, 'rows': 4}") for line in lines)
          and any("sharded render: (176, 320, 3)" in line and "finite: True" in line
                  for line in lines), "examples/multichip_torch.py printed the wrong lines")
    return {"s": time.perf_counter() - t0, "lines": lines}


def phase_multihost(torch, card: str) -> dict:
    """Phase 20: the multi-process form of `parallel/`, each leg in spawned
    workers (`parallel.launch`), so this process never joins a group."""
    sys.path.insert(0, ROOT)
    import graft_entry_torch
    from godotoceanwaves_tpu_torch.parallel import launch
    dev = torch.device("cuda", 0)
    out = {"card": card}
    t0 = time.perf_counter()
    out["a"] = launch.run(multihost_nccl_leg, 1, devices=[dev], backend="nccl",
                          timeout_s=MULTIHOST_TIMEOUT)
    out["a"]["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = launch.run(multihost_gloo_leg, 2, devices=[dev, dev], backend="gloo",
                          timeout_s=MULTIHOST_TIMEOUT)
    out["b"]["s"] = time.perf_counter() - t0
    b = out["b"]
    log(f"[20b] gloo probe with CUDA tensors: {b['probe']}; {b['world']} processes, mesh "
        f"{b['mesh']} owners {b['owners']}, positions on {b['positions']} at "
        f"{b['map_size']}^2: ms/frame (host clock, gloo loopback) "
        f"{[round(v, 2) for v in b['host_ms_per_frame']]}; max abs vs one controller "
        f"{b['max_abs_vs_one_controller']:.3e} (== 0); {b['s']:.1f} s; card {card}")
    # the example runs beside the dry run: both only check, neither is timed
    t0 = time.perf_counter()
    example = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", "multichip_torch.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        dry = graft_entry_torch.dryrun_multichip(SHARD_PATCHES, device="cuda",
                                                 timeout_s=MULTIHOST_TIMEOUT)
        out["c"] = {"dryrun": dry, "dryrun_s": time.perf_counter() - t0}
        log(f"[20c] dryrun_multichip({SHARD_PATCHES}) on the card: {dry['processes']} "
            f"{dry['backend']} process(es), mesh {dry['mesh']}, K3 vs torch.fft rel RMS "
            f"{dry['leg3_err']:.3e} at N = {dry['N']} ({dry['K3_launches']} K3 launches); "
            f"{out['c']['dryrun_s']:.1f} s")
        out["c"]["example"] = multihost_example(example, t0)
    finally:
        if example.poll() is None:
            example.kill()
            example.communicate()
    fn, args = graft_entry_torch.entry()
    reset_counts()
    _, maps = fn(*args)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[20c] graft_entry_torch.entry(): {tuple(maps.displacement.shape)} -> launches {counts}")
    check(counts == only(K1=2) and bool(maps.displacement.isfinite().all()),
          f"entry() should run K1 once (2 launches), counted {counts}")
    out["c"]["entry_launches"] = counts
    return out


def multihost_json(res: dict, phase16_ms: float | None) -> dict:
    a, b, c = res["a"], res["b"], res["c"]
    keep = lambda d, *keys: {k: d[k] for k in keys}
    return {"multihost": {
        "card": res["card"],
        "a": dict(keep(a, "backend", "world", "mesh", "launches_K3", "max_abs_vs_one_controller",
                       "gather_maps_equal", "restore_foam_max_abs", "restore_disp_max_abs",
                       "mesh_8x1_launches_K4", "ms_per_frame", "one_controller_ms_per_frame",
                       "host_ms_per_frame", "busy_ms_per_frame", "split_device_ms", "s"),
                  phase16_ms_per_frame=phase16_ms, patches=SHARD_PATCHES,
                  map_size=STRIP_SIZE, map_dtype="bfloat16", updates=CONFIG5_UPDATES),
        "b": keep(b, "backend", "world", "mesh", "owners", "probe", "positions", "map_size",
                  "frames", "host_ms_per_frame", "max_abs_vs_one_controller", "s"),
        "c": {"dryrun": keep(c["dryrun"], "backend", "processes", "mesh", "leg3_err",
                             "K3_launches", "N"),
              "dryrun_s": c["dryrun_s"], "example_s": c["example"]["s"],
              "entry_launches": c["entry_launches"]},
    }}


def phase_bench(torch, card: str, k1_ms: float | None) -> dict:
    """`python3 bench_torch.py` in a subprocess; checks its record."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                          capture_output=True, text=True, timeout=BENCH_TIMEOUT, cwd=ROOT)
    seconds = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines():
        log(f"[21] {line}")
    check(proc.returncode == 0, f"bench_torch.py exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 4, f"bench_torch.py printed {len(lines)} records, not 4")
    record = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in record]
    check(not missing and len(record) == len(BENCH_KEYS),
          f"bench record fields: missing {missing}, {len(record)} in all")
    check(record["rms_vs_oracle"] <= TOL_ORACLE,
          f"bench rms_vs_oracle {record['rms_vs_oracle']} > {TOL_ORACLE:g}")
    check(record["rms_tier"] == "fused" and record["config5_fft"] == "strip",
          f"bench tiers {record['rms_tier']!r}, {record['config5_fft']!r}")
    times = ("value", "config5_ms_frame", "render_ms_frame", "render_720p_scale2_ms",
             "render_720p_native_ms")
    check(all(record[k] > 0 for k in times), f"bench times {[record[k] for k in times]}")
    ratio = None if k1_ms is None else record["value"] / k1_ms
    log(f"[21] bench_torch.py: rc 0 in {seconds:.1f} s; config 4 {record['value']} ms/frame, "
        f"{'phase 5 not run' if ratio is None else f'{ratio:.3f}x phase 5 K1 pair {k1_ms:.4f}'}; "
        f"card {card}")
    if ratio is not None:
        check(BENCH_VS_PHASE5[0] <= ratio <= BENCH_VS_PHASE5[1],
              f"bench config 4 {record['value']} ms/frame is {ratio:.3f}x phase 5's K1 pair")
    return record


def pool_bytes(torch, pool) -> int | None:
    """The bytes of the device segments a `graphs.Pool` holds (the allocator's
    snapshot), None where the snapshot does not name pools."""
    if pool.handle is None:
        return 0
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments
               if tuple(seg["segment_pool_id"]) == tuple(pool.handle))


def graph_counts(before: dict) -> dict:
    return {k: v - before[k] for k, v in read_counts().items()}


def graph_equal_frames(torch, graphs, ocean, spray, r, cam) -> dict:
    """GRAPH_EQUAL_FRAMES scene frames, each rendered eagerly and replayed,
    with and without spray, at a pose and colours that change a frame:
    bit-equal, the same launches."""
    out = {"equal": True, "launches_eager": None, "launches_graphed": None}
    for i in range(GRAPH_EQUAL_FRAMES):
        maps = ocean.update(SCENE["dt"])
        scales = ocean.params.map_scales()
        attrs = spray.advance(maps, scales, SCENE["dt"])
        pose = (ocean.water_color * (1.0 + 0.1 * i), ocean.foam_color, cam + i,
                SCENE_PITCH - i, SCENE_YAW + 7.0 * i)
        for spray_attrs in (None, attrs):
            torch.cuda.synchronize()
            before = read_counts()
            with graphs.disabled():
                eager = r.render(maps, scales, *pose, spray_attrs=spray_attrs)
            torch.cuda.synchronize()
            e_counts = graph_counts(before)
            before = read_counts()
            got = r.render(maps, scales, *pose, spray_attrs=spray_attrs)
            torch.cuda.synchronize()
            g_counts = graph_counts(before)
            out["equal"] &= torch.equal(got, eager)
            want = only(K5=1, splat=int(spray_attrs is not None), fan=1)
            check(e_counts == g_counts == want,
                  f"launches a frame: eager {e_counts}, graphed {g_counts}; expected {want}")
            out["launches_eager"], out["launches_graphed"] = e_counts, g_counts
    return out


def device_ms_a_call(torch, call, match: str = "") -> float:
    """torch.profiler over SPLAT_REPEATS blocks of SPLAT_CALLS calls (device
    rows only): the device ms a call of the operations whose names hold
    `match` (every operation for ""), the median block."""
    from torch.profiler import DeviceType, ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    blocks = []
    for _ in range(SPLAT_REPEATS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SPLAT_CALLS):
                call()
            torch.cuda.synchronize()
        us = 0.0
        for e in prof.key_averages():
            if (getattr(e, "device_type", None) != DeviceType.CUDA or e.is_user_annotation
                    or match not in e.key):
                continue
            dev_us = getattr(e, "self_device_time_total", None)
            us += getattr(e, "self_cuda_time_total", 0.0) if dev_us is None else dev_us
        blocks.append(us / SPLAT_CALLS / 1e3)
    return sorted(blocks)[len(blocks) // 2]


def splat_work(torch, img, attrs, cam) -> dict:
    """What one splat call's inputs need: the lobes whose amplitude is not 0
    and whose window is on the frame, the weight products in their windows
    (rows x columns), the bytes of its inputs and output each moved once,
    and the least time of the two (HBM_TBPS; a product and its add at
    FP32_TFLOPS)."""
    from godotoceanwaves_tpu_torch.models import shading
    from godotoceanwaves_tpu_torch.ops import splat
    h, w = img.shape[0], img.shape[1]
    px, py, sig, amp = shading._spray_lobes(
        h, w, attrs["position"], attrs["scale"], attrs["dissolve"], attrs["visible"], cam,
        SCENE_PITCH, SCENE_YAW, 70.0, 0.666, attrs["custom_z"], "puff")
    r0, r1 = splat.lobe_window(py, sig, h)
    c0, c1 = splat.lobe_window(px, sig, w)
    live = (amp != 0) & px.isfinite() & py.isfinite() & (r0 <= r1) & (c0 <= c1)
    products = int(((r1 - r0 + 1) * (c1 - c0 + 1))[live].sum())
    p = attrs["position"].shape[0]
    # image in and out, positions, scales, dissolve, custom_z, the turns, visible
    moved = 2 * nbytes(img) + p * (3 + 3 + 1 + 1 + 2) * 4 + p
    least, by = bound(moved, 2.0 * products)
    return dict(lobes=px.numel(), live_lobes=int(live.sum()), window_products=products,
                bytes=moved, bound_ms=least, bound_by=by)


def splat_leg(torch, img, attrs, cam, foam) -> dict:
    """The splat alone at a frame's size: the kernel route (`splat_spray` on
    the card) and the plain route (`_splat_spray_plain`, the dense bf16
    contraction) on the same card tensors, in turns (CUDA events), each
    one's device time a call (torch.profiler: the chain's four kernels
    alone, and every operation of a call), their max abs, and the work."""
    from godotoceanwaves_tpu_torch.models import shading
    args = (img, attrs["position"], attrs["scale"], attrs["dissolve"], attrs["visible"])
    pose = dict(camera_pos=cam, pitch_deg=SCENE_PITCH, yaw_deg=SCENE_YAW, fov_deg=70.0,
                foam_color=foam, max_alpha=0.666)
    kernel = lambda: shading.splat_spray(*args, custom_z=attrs["custom_z"], **pose)
    plain = lambda: shading._splat_spray_plain(*args, *pose.values(), attrs["custom_z"], "puff")
    err = max_abs(kernel(), plain())
    return dict(in_turns(torch, {"plain": plain, "kernel": kernel}), max_abs=err,
                chain_device_ms=device_ms_a_call(torch, kernel, "splat_"),
                kernel_device_ms=device_ms_a_call(torch, kernel),
                plain_device_ms=device_ms_a_call(torch, plain),
                **splat_work(torch, img, attrs, cam))


def phase_graphs(torch, T, dev, card: str) -> dict:
    """Phase 22: the captured frame programs against `graphs.disabled()`."""
    from godotoceanwaves_tpu_torch.models import geometry
    from godotoceanwaves_tpu_torch.models.viewport import (FramePipeline, SpraySession,
                                                           make_batched_step)
    from godotoceanwaves_tpu_torch.utils import graphs, live
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    out = {}
    ocean, spray = scene_session(torch, T, dev)
    cam = torch.tensor(CAM0, device=dev)
    # the spray step through a restore, graphed and eager from one snapshot
    maps, scales = ocean.maps, ocean.params.map_scales()
    spray.advance(maps, scales, SCENE["dt"])
    snap = spray.checkpoint()
    runs = {}
    for mode in ("graphed", "eager"):
        with (graphs.disabled() if mode == "eager" else contextlib.nullcontext()):
            a = SpraySession(device=dev)
            a.restore(snap)
            for _ in range(GRAPH_SPRAY_STEPS):
                a.advance(maps, scales, SCENE["dt"])
            b = SpraySession(device=dev)
            b.restore(a.checkpoint())
            attrs = [b.advance(maps, scales, SCENE["dt"]) for _ in range(GRAPH_SPRAY_STEPS)]
            runs[mode] = (b.checkpoint()["state"], attrs)
    (gs, ga), (es, ea) = runs["graphed"], runs["eager"]
    spray_equal = (all(torch.equal(gs[k], es[k]) for k in es)
                   and all(torch.equal(g[k], e[k]) for g, e in zip(ga, ea) for k in e))
    log(f"[22] spray step ({SCENE['particles']} particles, one kernel launch an advance either "
        f"way): {GRAPH_SPRAY_STEPS} advances, a restore, {GRAPH_SPRAY_STEPS} more, graphs on vs "
        f"graphs.disabled(): bit-equal {spray_equal}")
    check(spray_equal, "the spray step differs with graphs on and off")
    out["spray_bit_equal"] = spray_equal

    # the ANSI field
    with graphs.disabled():
        want = live._sample_field_graphed(maps, scales, *GRAPH_FIELD)
    got = [live._sample_field_graphed(maps, scales, *GRAPH_FIELD) for _ in range(2)]
    field_equal = all(torch.equal(a, b) for g in got for a, b in zip(g, want))
    log(f"[22] ANSI field {GRAPH_FIELD[1]}x{GRAPH_FIELD[2]}: graphed vs eager bit-equal "
        f"{field_equal}")
    check(field_equal, "the graphed ANSI field differs from the eager one")
    out["field_bit_equal"] = field_equal

    for width, height, s in GRAPH_SIZES:
        tag = f"{width}x{height}" + (f" render_scale={s}" if s > 1 else "")
        r = scene_renderer(width, height, **({"render_scale": s} if s > 1 else {}))
        leg = {}
        reserved = torch.cuda.memory_reserved(dev)
        leg.update(graph_equal_frames(torch, graphs, ocean, spray, r, cam))
        leg["reserved_growth_GiB"] = (torch.cuda.memory_reserved(dev) - reserved) / 2 ** 30
        check(leg["equal"], f"{tag}: a replayed frame differs from the eager frame")
        leg["capture_s"] = {k: p.capture_seconds for k, p in r.programs.items()}
        leg["pool_GiB"] = (None if pool_bytes(torch, r.pool) is None
                           else pool_bytes(torch, r.pool) / 2 ** 30)
        pipe = FramePipeline()
        loop = lambda: pipe.push(scene_frame(ocean, spray, r, cam)[0])

        def eager_loop():
            with graphs.disabled():
                loop()
        attrs = spray.advance(ocean.maps, ocean.params.map_scales(), SCENE["dt"])
        wc, fc = ocean.water_color, ocean.foam_color

        def render_call(mode):
            def call():
                with (graphs.disabled() if mode == "eager" else contextlib.nullcontext()):
                    r.render(ocean.maps, scales, wc, fc, cam, SCENE_PITCH, SCENE_YAW,
                             spray_attrs=attrs)
            return call
        leg["render_spray"] = in_turns(torch, {"eager": render_call("eager"),
                                               "graphed": render_call("graphed")})
        img = r._scene(ocean.maps, scales, tuple(map(float, wc)), tuple(map(float, fc)), cam,
                       SCENE_PITCH, SCENE_YAW, 70.0)
        leg["splat"] = splat_leg(torch, img, attrs, cam, tuple(map(float, fc)))
        check(leg["splat"]["max_abs"] <= TOL_SPLAT_KERNEL,
              f"{tag}: the splat kernel disagrees with the plain route")
        leg["loop"] = in_turns(torch, {"eager": eager_loop, "graphed": loop})
        pipe.flush()
        for mode, frame in (("graphed", lambda: scene_frame(ocean, spray, r, cam)),
                            ("eager", lambda: eager_loop())):
            prof = profile_frames(torch, frame, f"{mode}_{width}x{height}_scale{s} ({tag})",
                                  leg["loop"][mode]["host_ms"], phase=22, stem="graph_profile")
            leg[f"busy_ms_{mode}"] = prof["busy_ms"]
            leg[f"busy_share_{mode}"] = prof["busy_ms"] / leg["loop"][mode]["host_ms"]
            leg[f"kernels_a_frame_{mode}"] = prof["launches"]
        # one replayed frame under sync-debug "error"
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            scene_frame(ocean, spray, r, cam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out[tag] = leg
        pool = ("not measured" if leg["pool_GiB"] is None
                else f"{leg['pool_GiB']:.3f} GiB")
        fmt = lambda d: (f"{d['ms']:.3f} ms (events) / {d['host_ms']:.3f} (host clock) "
                         f"[passes {', '.join(f'{v:.2f}' for v in d['ms_all'])} / "
                         f"{', '.join(f'{v:.2f}' for v in d['host_ms_all'])}]")
        log(f"[22] {tag}: {GRAPH_EQUAL_FRAMES} frames with and without spray, replayed vs "
            f"eager bit-equal {leg['equal']}, launches a frame {leg['launches_graphed']} (eager "
            f"{leg['launches_eager']}); captures {leg['capture_s']} s; pool "
            f"{pool}, "
            f"reserved grew {leg['reserved_growth_GiB']:.3f} GiB; card {card}")
        sp = leg["splat"]
        log(f"[22] {tag}: splat alone, kernel route {fmt(sp['kernel'])}, plain route "
            f"{fmt(sp['plain'])}; device ms a call: the chain's kernels "
            f"{sp['chain_device_ms']:.4f}, the kernel route's every operation "
            f"{sp['kernel_device_ms']:.4f}, the plain route's {sp['plain_device_ms']:.4f}; "
            f"{sp['live_lobes']} of {sp['lobes']} lobes live, {sp['window_products']} window "
            f"products, {sp['bytes'] / 1e6:.2f} MB: bound {sp['bound_ms']:.4f} ms "
            f"({sp['bound_by']}), {sp['bound_ms'] / sp['chain_device_ms']:.1%} of it; kernel vs "
            f"plain max |delta| {sp['max_abs']:.3e} (<= {TOL_SPLAT_KERNEL:g}); card {card}")
        log(f"[22] {tag}: render with spray eager {fmt(leg['render_spray']['eager'])}, graphed "
            f"{fmt(leg['render_spray']['graphed'])}; loop through FramePipeline eager "
            f"{fmt(leg['loop']['eager'])}, graphed {fmt(leg['loop']['graphed'])}; device busy "
            f"{leg['busy_ms_graphed']:.3f} ms = {leg['busy_share_graphed']:.1%} of the graphed "
            f"loop's frame ({leg['kernels_a_frame_graphed']:.0f} kernels), eager "
            f"{leg['busy_ms_eager']:.3f} ms = {leg['busy_share_eager']:.1%}; no host sync in a "
            f"replayed frame; card {card}")
        del r, pipe
        torch.cuda.empty_cache()

    # the K-frame step, graphed and eager from one state
    k = SCENE["batch"]
    r = scene_renderer(*SCENE_SIZES[0])
    sp_params, _ = spray.ensure_init()
    fn = make_batched_step(r, ocean.config, sp_params, k)
    results, counts, times = {}, {}, {}
    for mode in ("graphed", "eager"):
        with (graphs.disabled() if mode == "eager" else contextlib.nullcontext()):
            state, sps, clock, seq = ocean.state, spray._state, spray.clock, []
            torch.cuda.synchronize()
            before = read_counts()
            for _ in range(2):
                state, sps, frames, last = fn(state, ocean.params, sps, clock, ocean.water_color,
                                              ocean.foam_color, cam, SCENE_PITCH, SCENE_YAW,
                                              70.0, SCENE["dt"])
                clock += k * SCENE["dt"]
                seq.append((frames, state.foam, state.time, sps.start_time, sps.cycle,
                            last.displacement, last.normal))
            torch.cuda.synchronize()
            counts[mode] = graph_counts(before)
            carry = [ocean.state, spray._state]

            def tick():
                carry[0], carry[1], _, _ = fn(carry[0], ocean.params, carry[1], clock,
                                              ocean.water_color, ocean.foam_color, cam,
                                              SCENE_PITCH, SCENE_YAW, 70.0, SCENE["dt"])
            times[mode] = time_cuda(tick, iters=5, warmup=1) / k
            results[mode] = seq
    batched_equal = all(torch.equal(a, b) for g, e in zip(results["graphed"], results["eager"])
                        for a, b in zip(g, e))
    log(f"[22] make_batched_step(k={k}) at {SCENE_SIZES[0][0]}x{SCENE_SIZES[0][1]} with spray, "
        f"2 calls: graphed vs eager frames, state, spray state and last maps bit-equal "
        f"{batched_equal}; launches graphed {counts['graphed']}, eager {counts['eager']}; "
        f"ms a frame (CUDA events): graphed {times['graphed']:.3f}, eager {times['eager']:.3f}; "
        f"capture {fn.program.capture_seconds} s; card {card}")
    check(batched_equal, "the graphed K-frame step differs from the eager one")
    check(counts["graphed"] == counts["eager"] == only(K1=4 * k, K5=2 * k, splat=2 * k,
                                                       fan=2 * k, spray=2 * k),
          f"K-frame step launches: graphed {counts['graphed']}, eager {counts['eager']}")
    out["batched"] = dict(bit_equal=batched_equal, launches=counts["graphed"],
                          ms_frame_graphed=times["graphed"], ms_frame_eager=times["eager"],
                          capture_s=fn.program.capture_seconds)
    del fn, r
    torch.cuda.empty_cache()

    # the render legs of phase 13: one graphed program a frame (the render and
    # its pixel sum, as bench_torch.py times it) against the eager frame
    maps, scales = ocean.maps, ocean.params.map_scales()
    for leg, kw in RENDER_LEGS.items():
        def render_sum(eps, kw=kw):
            return render(geometry, maps, scales, cam=cam + torch.tanh(eps) * 1e-6, **kw).sum()
        program = graphs.graphed(render_sum)
        zero = torch.zeros((), device=dev)
        with graphs.disabled():
            want = render_sum(zero)
        equal = all(torch.equal(program(zero), want) for _ in range(2))
        check(equal, f"{leg}: the graphed frame's sum differs from the eager frame's")

        def chained(fn):
            carry = [zero]

            def frame():
                carry[0] = fn(carry[0])
            return frame
        res = in_turns(torch, {"eager": chained(render_sum), "graphed": chained(program)})
        out[f"leg {leg}"] = dict(res, bit_equal=equal, capture_s=program.capture_seconds)
        log(f"[22] render leg {leg} (phase 13's, chained): eager {res['eager']['ms']:.3f} ms "
            f"(events) / {res['eager']['host_ms']:.3f} (host clock), graphed "
            f"{res['graphed']['ms']:.3f} / {res['graphed']['host_ms']:.3f} [passes "
            f"{[round(v, 3) for v in res['graphed']['ms_all']]}]; sum bit-equal {equal}; "
            f"capture {program.capture_seconds} s; card {card}")
        del program
    return out


def fan_args(torch, geometry, maps, scales, width: int, height: int) -> tuple:
    """The arguments of the fan select in one frame at bench.py's render
    settings and pose (the frame cell's tier, camera height and pitch)."""
    from godotoceanwaves_tpu_torch.ops import fan
    calls, real = [], fan.fan_bracket

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    fan.fan_bracket = spy
    try:
        render(geometry, maps, scales, width=width, height=height)
    finally:
        fan.fan_bracket = real
    check(len(calls) == 1, f"{width}x{height}: {len(calls)} fan selects in a frame, not 1")
    return calls[0]


def fan_work(torch, args, tsel) -> dict:
    """What one select needs: its inputs read once and its outputs (found,
    t_lo, t_hi) written once; the compares this frame's walks make (from the
    window's first tau to the crossing or the window's end, each 5 fp32
    operations and a compare) and the worst case (every pixel over all J);
    the least time of each (HBM_TBPS, FP32_TFLOPS)."""
    hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam, _ = args
    px = s.numel()
    moved = nbytes(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable) + px * (1 + 4 + 4)
    first = torch.searchsorted(tau, t0 * dxz, right=True)          # first tau > tau0
    past = torch.searchsorted(tau, t1 * dxz, right=True)           # first tau > tau1
    found = torch.isfinite(tsel)
    hit = torch.searchsorted(tau, torch.where(found, tsel, 0.0))   # the crossing's index
    walked = torch.where(found, hit + 1, past) - first
    compares = int(torch.where(marchable, walked.clamp_min(0), 0).sum())
    worst = px * tau.numel()
    least, by = bound(moved, 6.0 * compares)
    worst_least, worst_by = bound(moved, 6.0 * worst)
    return dict(pixels=px, found=int(found.sum()), marchable=int(marchable.sum()),
                compares=compares, compares_worst=worst, bytes=moved, bound_ms=least,
                bound_by=by, bound_worst_ms=worst_least, bound_worst_by=worst_by)


def event_blocks(torch, call) -> list:
    """CUDA events around FAN_BLOCKS blocks of FAN_CALLS back-to-back calls:
    ms a call each block (host and device together: the slower sets it)."""
    call()
    torch.cuda.synchronize()
    out = []
    for _ in range(FAN_BLOCKS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FAN_CALLS):
            call()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / FAN_CALLS)
    return out


def phase_fan(torch, dev, maps, scales, card: str) -> dict:
    """Phase 23: the fan select's kernel against its plain chain."""
    from godotoceanwaves_tpu_torch.models import geometry
    from godotoceanwaves_tpu_torch.ops import fan
    median = lambda xs: sorted(xs)[len(xs) // 2]
    out = {}
    for width, height in FAN_SIZES:
        tag = f"{width}x{height}"
        args = fan_args(torch, geometry, maps, scales, width, height)
        kernel = lambda: fan.fan_bracket(*args)
        plain = lambda: fan.fan_bracket_plain(*args)
        got = fan.fan_bracket(*args, with_tsel=True)
        want = fan.fan_bracket_plain(*args, with_tsel=True)
        bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
        equal = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
        check(equal, f"{tag}: the fan kernel differs from the plain chain")
        work = fan_work(torch, args, want[3])
        runs = {"kernel": [], "plain": []}
        for name in ("kernel", "plain", "plain", "kernel"):
            runs[name] += event_blocks(torch, kernel if name == "kernel" else plain)
        k_blocks, p_blocks = runs["kernel"], runs["plain"]
        leg = dict(bit_equal=equal, g=args[5].shape[0] // args[2].shape[0],
                   call_ms=median(k_blocks), call_ms_all=k_blocks,
                   plain_ms=median(p_blocks), plain_ms_all=p_blocks,
                   device_ms=device_ms_a_call(torch, kernel, "fan_kernel"),
                   call_device_ms=device_ms_a_call(torch, kernel),
                   plain_device_ms=device_ms_a_call(torch, plain), **work)
        out[tag] = leg
        log(f"[23] fan select {tag} (g = {leg['g']}, J = {args[1].numel()}): kernel vs plain "
            f"chain bit-equal {equal}; {leg['found']} of {leg['marchable']} marchable of "
            f"{leg['pixels']} pixels found; events ms a call (medians of {len(k_blocks)} "
            f"blocks of {FAN_CALLS}): kernel call {leg['call_ms']:.4f}, plain chain "
            f"{leg['plain_ms']:.4f}; device ms a call (torch.profiler): the kernel "
            f"{leg['device_ms']:.4f}, the call's every operation {leg['call_device_ms']:.4f}, "
            f"the plain chain {leg['plain_device_ms']:.4f}; {leg['compares']} compares "
            f"({leg['compares_worst']} worst), {leg['bytes'] / 1e6:.2f} MB: bound "
            f"{leg['bound_ms']:.4f} ms ({leg['bound_by']}), "
            f"{leg['bound_ms'] / leg['device_ms']:.1%} of it; worst-case bound "
            f"{leg['bound_worst_ms']:.4f} ({leg['bound_worst_by']}); card {card}")
    return out


def spray_work(torch, fields, outs, attrs, maps) -> dict:
    """What one spray step needs: the state read once and written once, the
    attributes written once (custom_z is the state's), and every particle's
    bilinear taps, 4 texels of 3 normal and 3 displacement channels a
    cascade, each read once; the least time (HBM_TBPS)."""
    cascades = maps.displacement.shape[0]
    taps = len(fields[0]) * cascades * 4 * 6 * maps.displacement.element_size()
    moved = nbytes(*fields, *outs, attrs["position"], attrs["scale"], attrs["dissolve"],
                   attrs["visible"]) + taps
    least, by = bound(moved, 0.0)
    return dict(bytes=moved, bound_ms=least, bound_by=by)


def phase_spray(torch, T, dev, card: str) -> dict:
    """Phase 24: the spray step's kernel against its plain route at the
    frame cell's sizes."""
    from godotoceanwaves_tpu_torch.models import spray
    from godotoceanwaves_tpu_torch.ops import spray as spray_kernel
    median = lambda xs: sorted(xs)[len(xs) // 2]
    ocean, session = scene_session(torch, T, dev)
    scales = ocean.params.map_scales()
    for _ in range(SPRAY_WARM):
        session.advance(ocean.update(SPRAY_DT), scales, SPRAY_DT)
    params, state = session.ensure_init()
    clock = session.clock
    # a chain of advances on both routes from the warm state, on evolving maps
    got, want, equal = state, state, True
    for _ in range(SPRAY_CHAIN):
        maps = ocean.update(SPRAY_DT)
        clock += SPRAY_DT
        got, got_attrs = spray.spray_step(params, got, maps, scales, np.float32(clock))
        want, want_attrs = spray.spray_step_plain(params, want, maps, scales, np.float32(clock))
        bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
        equal &= all(torch.equal(bits(getattr(got, f)), bits(getattr(want, f)))
                     for f in spray_kernel.FIELDS)
        equal &= all(torch.equal(bits(got_attrs[k]), bits(want_attrs[k])) for k in want_attrs)
    check(equal, "the spray kernel differs from its plain route")
    maps, now = ocean.maps, np.float32(clock + SPRAY_DT)
    kernel = lambda: spray.spray_step(params, got, maps, scales, now)
    plain = lambda: spray.spray_step_plain(params, got, maps, scales, now)
    runs = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        runs[name] += event_blocks(torch, kernel if name == "kernel" else plain)
    new, attrs = kernel()
    fields = [getattr(got, f) for f in spray_kernel.FIELDS]
    outs = [getattr(new, f) for f in spray_kernel.FIELDS]
    out = dict(bit_equal=equal, particles=params.num_particles,
               started=int(new.has_started.sum()), active=int(new.active.sum()),
               visible=int(attrs["visible"].sum()), call_ms=median(runs["kernel"]),
               call_ms_all=runs["kernel"], plain_ms=median(runs["plain"]),
               plain_ms_all=runs["plain"],
               device_ms=device_ms_a_call(torch, kernel, "spray_kernel"),
               call_device_ms=device_ms_a_call(torch, kernel),
               plain_device_ms=device_ms_a_call(torch, plain),
               **spray_work(torch, fields, outs, attrs, maps))
    out["roofline"] = out["bound_ms"] / out["device_ms"]
    log(f"[24] spray step ({out['particles']} particles, {SCENE['map_size']}^2 "
        f"{SCENE['map_dtype']} x 3): {SPRAY_CHAIN} chained advances, kernel vs plain route "
        f"bit-equal {equal}; {out['started']} started, {out['active']} active, "
        f"{out['visible']} visible; events ms a call (medians of {len(runs['kernel'])} blocks "
        f"of {FAN_CALLS}): kernel route {out['call_ms']:.4f}, plain route "
        f"{out['plain_ms']:.4f}; device ms a call (torch.profiler, medians of "
        f"{SPLAT_REPEATS} blocks): the kernel {out['device_ms']:.4f}, the call's every "
        f"operation {out['call_device_ms']:.4f}, the plain route "
        f"{out['plain_device_ms']:.4f}; {out['bytes'] / 1e6:.2f} MB: bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}), {out['roofline']:.1%} of it; "
        f"card {card}")
    return out


def main(argv: list) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import godotoceanwaves_tpu_torch as T
    from godotoceanwaves_tpu_torch import parallel as par
    from godotoceanwaves_tpu_torch.ops import _build, fft, fused_step as fs
    from godotoceanwaves_tpu_torch.ops import planes_fft as pf, rows_fft as rf, strip_step as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_toolchain(torch, _build)
    if argv == ["--alone"]:
        # phases 10, 11 and 17 only: K5 and K6 against their plain versions, then alone
        ocean = T.Ocean(map_size=RENDER_MAP, map_dtype="bfloat16", updates_per_second=0,
                        device=dev)
        maps0 = ocean.update(1 / 60)
        tap_res = phase_tap_vs_plain(torch, T, dev, maps0, ocean.params.map_scales())
        march_res = phase_march_vs_plain(torch, dev, maps0, ocean.params.map_scales())
        alone = phase_kernels_alone(torch, tap_res, march_res, card)
        log(json.dumps({"alone": {k: {key: v[key] for key in ("ms", "device_ms", "call_ms",
                                                               "ops_per_call", "plain_ms", "bound")}
                                  for k, v in alone.items()}}))
        log(card_line())
        return 0
    if argv == ["--scene"]:
        # phase 18 only: the scene frame loop, its checks and its timing
        scene = phase_scene(torch, T, dev)
        log(json.dumps(scene_json(scene, phase_scene_timing(torch, dev, scene, card), card)))
        log(card_line())
        return 0
    if argv == ["--web"]:
        # phase 19 only: the browser viewer on the card
        log(json.dumps({"web": phase_web(torch, T, dev, card)}))
        log(card_line())
        return 0
    if argv == ["--multihost"]:
        # phase 20 only: the multi-process legs
        log(json.dumps(multihost_json(phase_multihost(torch, card), None)))
        log(card_line())
        return 0
    if argv == ["--bench"]:
        # phase 21 only: bench_torch.py and its record
        log(json.dumps({"bench": phase_bench(torch, card, None)}))
        log(card_line())
        return 0
    if argv == ["--graphs"]:
        # phase 22 only: the captured frame programs against eager
        log(json.dumps({"graphs": phase_graphs(torch, T, dev, card)}))
        log(card_line())
        return 0
    if argv == ["--fan"]:
        # phase 23 only: the fan select's kernel against its plain chain
        ocean = T.Ocean(map_size=RENDER_MAP, map_dtype="bfloat16", updates_per_second=0,
                        device=dev)
        maps0 = ocean.update(1 / 60)
        log(json.dumps({"fan": phase_fan(torch, dev, maps0, ocean.params.map_scales(), card)}))
        log(card_line())
        return 0
    if argv == ["--spray"]:
        # phase 24 only: the spray step's kernel against its plain route
        log(json.dumps({"spray": phase_spray(torch, T, dev, card)}))
        log(card_line())
        return 0
    if argv:
        print(f"usage: {sys.argv[0]} [--alone | --scene | --web | --multihost | --bench | "
              "--graphs | --fan | --spray]", file=sys.stderr)
        return 2
    errs = phase_kernel_vs_plain(torch, T, fs, dev)
    phase_oracle(torch, T, fs, dev)
    k1_launches = phase_main_path(torch, T, fs, dev)
    k1_ms, k1_plain_ms, k1_bound = phase_timing(torch, T, fs, dev, card)
    strip_errs = phase_strip_vs_plain(torch, T, ss, fs, dev)
    planes_errs = phase_planes_vs_plain(torch, pf, fft, dev)
    c5 = phase_config5(torch, T, dev)
    timing = phase_timing_config5(torch, T, ss, pf, fs, fft, dev, card)
    ocean = T.Ocean(map_size=RENDER_MAP, map_dtype="bfloat16", updates_per_second=0, device=dev)
    maps0 = ocean.update(1 / 60)
    tap_res = phase_tap_vs_plain(torch, T, dev, maps0, ocean.params.map_scales())
    march_res = phase_march_vs_plain(torch, dev, maps0, ocean.params.map_scales())
    path = phase_render_path(torch, dev, ocean)
    phase_render_timing(torch, dev, path["maps"], path["scales"], card)
    fan_line = {"fan": phase_fan(torch, dev, path["maps"], path["scales"], card)}
    del ocean, maps0, path["maps"]
    torch.cuda.empty_cache()
    spray_line = {"spray": phase_spray(torch, T, dev, card)}
    torch.cuda.empty_cache()
    rows_errs = phase_rows_vs_plain(torch, rf, fft, dev)
    shard4 = phase_sharded_main(torch, T, par, dev)
    shard5 = phase_sharded_config5(torch, T, par, dev)
    stime = phase_sharded_timing(torch, par, rf, fft, dev, shard5, card)
    alone = phase_kernels_alone(torch, tap_res, march_res, card)
    for key, res in alone.items():
        check(res["ops_per_call"] == 1,
              f"{key}: a wrapper call ran {res['ops_per_call']} device operations, not one kernel")
    torch.cuda.empty_cache()
    scene = phase_scene(torch, T, dev)
    scene_line = scene_json(scene, phase_scene_timing(torch, dev, scene, card), card)
    del scene
    torch.cuda.empty_cache()
    web_line = {"web": phase_web(torch, T, dev, card)}
    torch.cuda.empty_cache()
    multihost_line = multihost_json(phase_multihost(torch, card), stime["step"]["ms_per_frame"])
    bench_line = {"bench": phase_bench(torch, card, k1_ms)}
    torch.cuda.empty_cache()
    graphs_line = {"graphs": phase_graphs(torch, T, dev, card)}
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    k2_ms, k2_plain_ms, k2_lib_ms, k2_bound = timing[("K2", PLANES_L, STRIP_SIZE)]
    k3_ms, k3_plain_ms, k3_lib_ms, k3_bound = stime["K3"]
    k4_ms, k4_plain_ms = timing["K4"]
    bounds = lambda b: {"bound_ms": b[0], "bound_by": b[1]}
    log(json.dumps({"sharded": {
        "config5": dict(stime["step"], mesh=shard5["mesh"].shape, patches=SHARD_PATCHES,
                        cascades=2, map_size=STRIP_SIZE, map_dtype="bfloat16",
                        launches_K3=shard5["launches"], max_abs_err_vs_K4=shard5["max_abs"],
                        band_max_abs_err=shard5["band_err"], sky_share=shard5["sky"]),
        "config4_shape": dict(mesh={"patch": 1, "rows": SHARD_ROWS_MAIN}, cascades=4,
                              map_size=MAIN_SIZE, frames=SHARD_FRAMES,
                              launches_K3=shard4["launches"], max_abs_err_vs_K1=shard4["max_abs"]),
    }}))
    log(json.dumps(scene_line))
    log(json.dumps(web_line))
    log(json.dumps(multihost_line))
    log(json.dumps(bench_line))
    log(json.dumps(graphs_line))
    log(json.dumps(fan_line))
    log(json.dumps(spray_line))
    log(card_line())
    log(json.dumps({"kernels": [
        dict(KERNELS["K1"], route="cuda", launches=k1_launches,
             max_abs_err=errs[(MAIN_SIZE, torch.bfloat16, 1)],
             max_abs_err_fp32=errs[(MAIN_SIZE, torch.float32, 1)],
             ms=k1_ms, plain_ms=k1_plain_ms, **bounds(k1_bound), library_ms=None,
             shape=f"4 x {MAIN_SIZE}^2 bf16 maps"),
        dict(KERNELS["K2"], route="cuda", launches=c5["launches_K2"],
             max_abs_err=planes_errs[(STRIP_SIZE, True)],
             max_abs_err_8192=planes_errs[(8192, True)],
             ms=k2_ms, plain_ms=k2_plain_ms, **bounds(k2_bound), library_ms=k2_lib_ms,
             shape=f"{PLANES_L} x {STRIP_SIZE}^2 planes"),
        dict(KERNELS["K3"], route="cuda", launches=shard5["launches"],
             max_abs_err=rows_errs[ROWS_SHAPES[0] + (True,)],
             max_abs_err_8192=rows_errs[ROWS_SHAPES[-1] + (True,)],
             ms=k3_ms, plain_ms=k3_plain_ms, **bounds(k3_bound), library_ms=k3_lib_ms,
             shape="({}, 2, {}, {}) planes, the config-5 shard at rows = 2".format(
                 *ROWS_SHAPES[0])),
        dict(KERNELS["K4"], route="cuda", launches=c5["launches_K4"],
             max_abs_err=strip_errs[(STRIP_SIZE, torch.bfloat16, 1)],
             max_abs_err_fp32=strip_errs[(STRIP_SIZE, torch.float32, 1)],
             ms=k4_ms, plain_ms=k4_plain_ms, **bounds(timing["K4_bound"]), library_ms=None,
             shape=f"2 x {STRIP_SIZE}^2 bf16 maps", rows_ms=timing["K4_passes"]["rows_ms"],
             cols_ms=timing["K4_passes"]["cols_ms"], k2_same_planes_ms=timing["K4_passes"]["k2_ms"],
             **{f"ms_1x{n}": timing[("K4", n)][0] for n in STRIP_BIG},
             **{f"bound_ms_1x{n}": timing[("K4", n)][3][0] for n in STRIP_BIG}),
        dict(KERNELS["K5"], route="cuda", launches=path["launches_K5"],
             max_abs_err=max(tap_res["random"], tap_res["real"]),
             max_abs_err_real_frame=tap_res["real"], **alone_entry(alone["K5 frame"]),
             library_ms=None, shape=f"the arguments of one {TAP_FRAME} frame",
             **alone_entry(alone["K5 random"], "_random")),
        dict(KERNELS["K6"], route="cuda", launches=path["launches_K6"],
             max_abs_err=march_res["max_abs"], found_agree=march_res["agree"],
             **alone_entry(alone["K6 640x360"]), library_ms=None,
             shape="640x360 rays, G = 256 table, 32 steps + 2 refine rounds",
             **alone_entry(alone["K6 1280x720"], "_1280x720")),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
