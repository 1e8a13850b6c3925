#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, each of which raises on failure:

1. Toolchain: CUDA version, nvcc, card name and power limit; builds
   `godotoceanwaves_tpu_torch/csrc/*.cu` with nvcc (one process per source,
   in parallel) and prints the build time and ptxas lines.
2. The fused-step kernel pair (K1) against its plain PyTorch version,
   single frame and K=3 frames, at N = 128 and 1024, 3 cascades, seeded
   foam; one fp32 step at each other power of two from 16 to 512.
3. Parity with the NumPy transcription of the reference shaders
   (tests/oracle.py): one 512^2 step of cascade 0, fp32 maps, via K1.
4. Config 4: `Ocean.update` x 60 and `multi_step(..., 8)` at 4 cascades x
   1024^2 with bf16 maps (K1); launch counts, finiteness, foam range, height
   statistics, and agreement with the same run on the staged path, whose FFT
   is the planes kernel (K2).
5. Timing with CUDA events: K1 vs plain ms/frame at config 4.
6. The strip-step kernel pair (K4) against its plain version: N = 2048 with
   config 5's 2 cascades, every map dtype, 1 frame and 3 frames through
   `multi_step`, seeded foam; N = 4096 and 8192 with 1 cascade, fp32 and bf16.
7. The planes IFFT kernel pair (K2) against `fft.ifft2_packed_planes`
   (torch.fft): N = 16, 1024, 2048 and 8192, L = 8, both fold_sign values.
8. Config 5: `Ocean.update` x 48 at 2 cascades x 2048^2 with bf16 maps (K4),
   the same run with fused="never" (K2), compared; then `MapStreamer`'s
   full-resolution, native-dtype and preview legs.
9. Timing with CUDA events: K4 vs plain ms/frame at config 5, with its row
   and column passes alone; K2 vs torch.fft at 16 x 1024^2 and 8 x 2048^2.

Prints a JSON line of the kernels, the card's name and power limit, then as
its last line {"ok": true, "device": {...}}. Exits non-zero, with no result
line, when no CUDA device is present or any phase fails. Imports nothing of
JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "godotoceanwaves_tpu_torch/csrc/"
KERNELS = {
    "K1": dict(name="fused_step (rows + cols)", source=CSRC + "fused_step.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_step.py:328"),
    "K2": dict(name="planes_fft (rows + cols)", source=CSRC + "planes_fft.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_fft.py:345"),
    "K4": dict(name="strip_step (rows + cols)", source=CSRC + "strip_step.cu",
               replaces="godotoceanwaves_tpu/ops/pallas_strip.py:188"),
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


def launch_counts():
    from godotoceanwaves_tpu_torch.ops import fused_step, planes_fft, strip_step
    return {"K1": fused_step, "K2": planes_fft, "K4": strip_step}


def reset_counts() -> None:
    for module in launch_counts().values():
        module.LAUNCHES = 0


def read_counts() -> dict:
    return {k: module.LAUNCHES for k, module in launch_counts().items()}


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
    build.load()
    return card


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
            before = fs.LAUNCHES
            got = fs.fused_cascade_step(*args, single, map_dtype=md)
            torch.cuda.synchronize()
            check(fs.LAUNCHES == before + 2, "fused_cascade_step did not launch the kernels")
            ref = fs.fused_cascade_step_reference(*args, single, map_dtype=md)
            errs[(n, md, 1)] = compare_maps(f"[2] N={n} {md} step", got, ref, two_byte)

            before = fs.LAUNCHES
            got = fs.fused_cascade_multi_step(*args, multi, num_frames=3, map_dtype=md)
            torch.cuda.synchronize()
            check(fs.LAUNCHES == before + 6, "fused_cascade_multi_step did not launch 3 frames")
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
    before = fs.LAUNCHES
    _, maps = T.step(cfg, state, params, dt)
    check(fs.LAUNCHES == before + 2, "step() did not go through the kernel")
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
    check(counts == {"K1": 2 * 68, "K2": 0, "K4": 0},
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
    check(counts == {"K1": 0, "K2": 2 * 68, "K4": 0},
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
        f"Ocean.update() host clock over 100 calls {update_ms:.4f}; card {card}")
    return ms, plain_ms


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
            before = ss.LAUNCHES
            got = ss.strip_cascade_step(*args, map_dtype=md)
            torch.cuda.synchronize()
            check(ss.LAUNCHES == before + 2, "strip_cascade_step did not launch the kernels")
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
            before = ss.LAUNCHES
            new_st, maps = multi_step(cfg, st, params, dt, 3)
            torch.cuda.synchronize()
            check(ss.LAUNCHES == before + 6, "multi_step(3) did not launch K4 three times")
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
            before = pf.LAUNCHES
            got = pf.ifft2_packed_planes(x, fold_sign=fold)
            torch.cuda.synchronize()
            check(pf.LAUNCHES == before + 2, "ifft2_packed_planes did not launch the kernels")
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
    check(counts["auto"] == {"K1": 0, "K2": 0, "K4": 2 * CONFIG5_UPDATES},
          f"config 5 expected {2 * CONFIG5_UPDATES} K4 launches only, counted {counts['auto']}")
    check(counts["never"] == {"K1": 0, "K2": 2 * CONFIG5_UPDATES, "K4": 0},
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
    from godotoceanwaves_tpu_torch.ops import _build
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
    state = [st]

    def one_step():
        state[0], _ = step(ocean.config, state[0], p, dt)
    step_ms = time_cuda(one_step, iters=20)

    # the two passes alone, on the wrapper's own buffers
    lib = _build.load()
    c, n = 2, STRIP_SIZE
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = torch.empty((c, n, n, 8), dtype=torch.float32, device=dev)
    disp = torch.empty((c, 3, n, n), dtype=torch.bfloat16, device=dev)
    normal = torch.empty((c, 4, n, n), dtype=torch.bfloat16, device=dev)
    foam_out = torch.empty_like(st.foam)
    rows = lambda: lib.strip_step_rows(st.h0.data_ptr(), st.h0nc.data_ptr(), st.omega.data_ptr(),
                                       scal.data_ptr(), scratch.data_ptr(), c, n, stream)
    cols = lambda: lib.strip_step_cols(scratch.data_ptr(), st.foam.data_ptr(), scal.data_ptr(),
                                       disp.data_ptr(), normal.data_ptr(), foam_out.data_ptr(),
                                       c, n, 1, disp.stride(0), normal.stride(0), stream)
    check(rows() == 0 and cols() == 0, "a strip pass failed to launch")
    rows_ms = time_cuda(rows, iters=50)
    cols_ms = time_cuda(cols, iters=50)
    texels = c * n * n
    rows_bytes = texels * (8 + 8 + 4 + 32)          # h0, h0nc, omega in; scratch out
    cols_bytes = texels * (32 + 4 + 4 + 7 * 2)      # scratch, foam in; foam, bf16 maps out
    out["K4_rows"] = (rows_ms, rows_bytes / rows_ms / 1e9)
    out["K4_cols"] = (cols_ms, cols_bytes / cols_ms / 1e9)
    log(f"[9] config 5 (2 x {n}^2 bf16), ms/frame (CUDA events, best of 3 x 20): K4 {ms:.4f}, "
        f"plain {plain_ms:.4f}, step() {step_ms:.4f}; turns {[round(x, 4) for x in t]}; "
        f"row pass {rows_ms:.4f} ms ({rows_bytes / rows_ms / 1e9:.3f} TB/s of "
        f"{rows_bytes / 1e6:.1f} MB), column pass {cols_ms:.4f} ms "
        f"({cols_bytes / cols_ms / 1e9:.3f} TB/s of {cols_bytes / 1e6:.1f} MB); card {card}")
    del ocean, st, args, scratch, disp, normal, foam_out, state
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(11)
    for l, n in ((16, 1024), (PLANES_L, STRIP_SIZE)):
        x = torch.randn((l, 2, n, n), generator=gen, device=dev)
        ms, plain_ms, t = turns(time_cuda, lambda: fft.ifft2_packed_planes(x, fold_sign=True),
                                lambda: pf.ifft2_packed_planes(x, fold_sign=True))
        out[("K2", l, n)] = (ms, plain_ms)
        moved = 32 * l * n * n
        log(f"[9] K2 {l} x {n}^2 planes, ms (CUDA events, best of 3 x 20): kernel {ms:.4f} "
            f"({moved / ms / 1e9:.3f} TB/s of {moved / 1e6:.1f} MB), torch.fft {plain_ms:.4f}; "
            f"turns {[round(v, 4) for v in t]}; card {card}")
        del x
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import godotoceanwaves_tpu_torch as T
    from godotoceanwaves_tpu_torch.ops import _build, fft, fused_step as fs
    from godotoceanwaves_tpu_torch.ops import planes_fft as pf, strip_step as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_toolchain(torch, _build)
    errs = phase_kernel_vs_plain(torch, T, fs, dev)
    phase_oracle(torch, T, fs, dev)
    k1_launches = phase_main_path(torch, T, fs, dev)
    k1_ms, k1_plain_ms = phase_timing(torch, T, fs, dev, card)
    strip_errs = phase_strip_vs_plain(torch, T, ss, fs, dev)
    planes_errs = phase_planes_vs_plain(torch, pf, fft, dev)
    c5 = phase_config5(torch, T, dev)
    timing = phase_timing_config5(torch, T, ss, pf, fs, fft, dev, card)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    k2_ms, k2_plain_ms = timing[("K2", PLANES_L, STRIP_SIZE)]
    k4_ms, k4_plain_ms = timing["K4"]
    log(card_line())
    log(json.dumps({"kernels": [
        dict(KERNELS["K1"], route="cuda", launches=k1_launches,
             max_abs_err=errs[(MAIN_SIZE, torch.bfloat16, 1)],
             max_abs_err_fp32=errs[(MAIN_SIZE, torch.float32, 1)],
             ms=k1_ms, plain_ms=k1_plain_ms),
        dict(KERNELS["K2"], route="cuda", launches=c5["launches_K2"],
             max_abs_err=planes_errs[(STRIP_SIZE, True)],
             max_abs_err_8192=planes_errs[(8192, True)],
             ms=k2_ms, plain_ms=k2_plain_ms, shape=f"{PLANES_L} x {STRIP_SIZE}^2 planes"),
        dict(KERNELS["K4"], route="cuda", launches=c5["launches_K4"],
             max_abs_err=strip_errs[(STRIP_SIZE, torch.bfloat16, 1)],
             max_abs_err_fp32=strip_errs[(STRIP_SIZE, torch.float32, 1)],
             ms=k4_ms, plain_ms=k4_plain_ms, shape=f"2 x {STRIP_SIZE}^2 bf16 maps"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
