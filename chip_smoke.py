#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (sm_90a)
and the CUDA toolkit. Phases, each of which raises on failure:

1. Toolchain: CUDA version, nvcc, card name and power limit; builds
   `godotoceanwaves_tpu_torch/csrc/*.cu` with nvcc and prints the build time.
2. The fused-step kernel pair against its plain PyTorch version on the card,
   single frame and K=3 frames, at N = 128 and 1024, 3 cascades, seeded foam;
   one fp32 step at each other power of two from 16 to 512.
3. Parity with the NumPy transcription of the reference shaders
   (tests/oracle.py): one 512^2 step of cascade 0, fp32 maps, via the kernel.
4. The main path: `Ocean.update` x 60 and `multi_step(..., 8)` at 4 cascades
   x 1024^2 with bf16 maps; launch counts, finiteness, foam range, height
   statistics, and agreement with the same run on the plain path.
5. Timing with CUDA events: kernel vs plain ms/frame at that shape.

Prints a JSON line of the kernels, then as its last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when no
CUDA device is present or any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "godotoceanwaves_tpu_torch/csrc/fused_step.cu"
REPLACES = "godotoceanwaves_tpu/ops/pallas_step.py:328"

# Tolerances. fp32 maps: the kernel and torch.fft differ only in summation
# order and twiddle rounding. 2-byte maps: one rounding of the fp32 fields can
# land on either side of a bf16/f16 step (the class tests/test_pallas_step.py
# uses for 2-byte maps).
TOL_F32 = 1e-4          # relative RMS, displacement and normal
TOL_FOAM = 1e-4         # RMS, foam (fp32 either way)
TOL_2B_DISP = 1e-3      # relative RMS, displacement
TOL_2B_NORMAL = 2e-3    # RMS, normal
TOL_ORACLE = 1e-4       # relative RMS vs tests/oracle.py

KERNEL_SIZES = (128, 1024)   # phase 2, every dtype, 1 and 3 frames
SWEEP_SIZES = (16, 32, 64, 256, 512)   # phase 2, the rest of 16..1024, fp32
ORACLE_SIZE = 512            # phase 3 (bench.py's RMS leg)
MAIN_SIZE = 1024             # phases 4-5 (bench.py config 4)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_rms(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(1e-12, float(np.sqrt(np.mean(ref * ref))))
    return float(np.sqrt(np.mean((got - ref) ** 2))) / scale


def rms(got, ref) -> float:
    d = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def host(t):
    return t.detach().float().cpu().numpy()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_toolchain(torch, build) -> str:
    log(f"[1] torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    log(f"[1] nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    path, nvcc_log = build.compile_library()
    log(f"[1] built {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[1] ptxas: {line.strip()}")
    build.load()
    return card


def seeded_inputs(torch, T, n: int, dev):
    params = T.default_cascades(device=dev)
    state = T.init_state(T.SimConfig(map_size=n), params)
    rng = np.random.default_rng(n)
    foam = torch.from_numpy(rng.uniform(0.0, 0.5, (3, n, n)).astype(np.float32)).to(dev)
    return params, state.replace(foam=foam)


def compare_maps(tag, got, ref, two_byte: bool) -> float:
    """Checks (disp, normal[, foam]) against the plain version; returns the
    max abs error."""
    got, ref = [host(x) for x in got], [host(x) for x in ref]
    e_d = rel_rms(got[0], ref[0])
    e_n = rms(got[1], ref[1]) if two_byte else rel_rms(got[1], ref[1])
    e_f = rms(got[2], ref[2]) if len(got) == 3 else 0.0
    tol_d, tol_n = (TOL_2B_DISP, TOL_2B_NORMAL) if two_byte else (TOL_F32, TOL_F32)
    log(f"[2] {tag}: disp {e_d:.3e} (<= {tol_d:g}), normal {e_n:.3e} (<= {tol_n:g})"
        + (f", foam {e_f:.3e} (<= {TOL_FOAM:g})" if len(got) == 3 else ""))
    check(e_d <= tol_d and e_n <= tol_n and e_f <= TOL_FOAM, f"{tag} disagrees with plain")
    return max(float(np.abs(a - b).max()) for a, b in zip(got, ref))


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
            errs[(n, md, 1)] = compare_maps(f"N={n} {md} step", got, ref, two_byte)

            before = fs.LAUNCHES
            got = fs.fused_cascade_multi_step(*args, multi, num_frames=3, map_dtype=md)
            torch.cuda.synchronize()
            check(fs.LAUNCHES == before + 6, "fused_cascade_multi_step did not launch 3 frames")
            ref = fs.fused_cascade_multi_step_reference(*args, multi, num_frames=3, map_dtype=md)
            check(tuple(got[0].shape) == (3, 3, 3, n, n), f"multi-step shape {tuple(got[0].shape)}")
            for k in range(3):
                last = (got[2],) if k == 2 else ()
                errs[(n, md, 3)] = max(errs.get((n, md, 3), 0.0), compare_maps(
                    f"N={n} {md} frame {k + 1}/3", (got[0][:, k], got[1][:, k]) + last,
                    (ref[0][:, k], ref[1][:, k]) + ((ref[2],) if last else ()), two_byte))
    for n in SWEEP_SIZES:
        params, st = seeded_inputs(torch, T, n, dev)
        grow, decay = _foam_rates(params, 0.1)
        scal = fs.pack_scalars(st.time + 0.1, params.tile_length, params.whitecap, grow, decay)
        args = (st.h0, st.h0nc, st.omega, st.foam, scal)
        got = fs.fused_cascade_step(*args, map_dtype=torch.float32)
        ref = fs.fused_cascade_step_reference(*args, map_dtype=torch.float32)
        compare_maps(f"N={n} {torch.float32} step", got, ref, two_byte=False)
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
    fs.LAUNCHES = 0
    for _ in range(60):
        maps = ocean.update(1 / 50)
        check(maps is not None, "uncapped update() skipped a frame")
    time_60 = ocean.state.time.clone()
    ocean.state, maps = multi_step(ocean.config, ocean.state, ocean.params, 1 / 50, 8)
    torch.cuda.synchronize()
    launches = fs.LAUNCHES
    log(f"[4] main path: 60 update() + multi_step(8) -> {launches} kernel launches")
    check(launches == 2 * (60 + 8), f"expected {2 * 68} launches, counted {launches}")

    d, nm, foam = host(maps.displacement), host(maps.normal), host(ocean.state.foam)
    check(maps.displacement.dtype == torch.bfloat16, "maps are not bf16")
    check(np.isfinite(d).all() and np.isfinite(nm).all(), "maps are not finite")
    check(foam.min() >= 0.0 and foam.max() <= 1.0, "foam left [0, 1]")
    coverage = float((foam > 0).mean())
    check(coverage > 0.0, "no foam at all")
    stds = [float(d[c, 1].std()) for c in range(4)]
    log(f"[4] height std per cascade {[round(s, 3) for s in stds]} m, foam coverage "
        f"{coverage:.3f}, time {host(ocean.state.time).tolist()}")
    check(all(0.1 <= s <= 3.0 for s in stds), "height std outside 0.1-3 m")

    plain = main_path_ocean(torch, T, dev, "never")
    for _ in range(60):
        plain.update(1 / 50)
    check(torch.equal(time_60, plain.state.time), "time after 60 updates differs from plain")
    plain.state, pmaps = multi_step(plain.config, plain.state, plain.params, 1 / 50, 8)
    check(fs.LAUNCHES == launches, "the plain path launched the kernel")
    e_d = rel_rms(d, host(pmaps.displacement))
    e_n = rms(nm, host(pmaps.normal))
    e_f = rms(foam, host(plain.state.foam))
    log(f"[4] vs plain path after 68 frames: disp {e_d:.3e} (<= {TOL_2B_DISP:g}), normal "
        f"{e_n:.3e} (<= {TOL_2B_NORMAL:g}), foam {e_f:.3e} (<= {TOL_FOAM:g})")
    check(e_d <= TOL_2B_DISP and e_n <= TOL_2B_NORMAL and e_f <= TOL_FOAM,
          "main path disagrees with the plain path")
    # multi_step's frame k runs at t0 + k*dt (the K1 kernel's semantics); the
    # plain loop accumulates dt, which may differ by an fp32 ulp
    check(torch.allclose(ocean.state.time, plain.state.time, rtol=1e-6, atol=0.0),
          "time after multi_step differs from the plain path")
    return launches


def phase_timing(torch, T, fs, dev, card: str) -> tuple[float, float]:
    from godotoceanwaves_tpu_torch.models.ocean import _foam_rates, step
    from godotoceanwaves_tpu_torch.utils.timing import time_cuda
    ocean = main_path_ocean(torch, T, dev, "auto")
    st, p = ocean.state, ocean.params
    dt = torch.tensor(0.02, device=dev)
    grow, decay = _foam_rates(p, dt)
    scal = fs.pack_scalars(st.time + dt, p.tile_length, p.whitecap, grow, decay)
    args = (st.h0, st.h0nc, st.omega, st.foam, scal)
    kernel = lambda: fs.fused_cascade_step(*args, map_dtype=torch.bfloat16)
    plain = lambda: fs.fused_cascade_step_reference(*args, map_dtype=torch.bfloat16)
    # turns: plain, kernel, kernel, plain
    t = [time_cuda(f, iters=20) for f in (plain, kernel, kernel, plain)]
    ms, plain_ms = min(t[1], t[2]), min(t[0], t[3])
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import godotoceanwaves_tpu_torch as T
    from godotoceanwaves_tpu_torch.ops import _build, fused_step as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_toolchain(torch, _build)
    errs = phase_kernel_vs_plain(torch, T, fs, dev)
    phase_oracle(torch, T, fs, dev)
    launches = phase_main_path(torch, T, fs, dev)
    ms, plain_ms = phase_timing(torch, T, fs, dev, card)

    log(card_line())
    log(json.dumps({"kernels": [{
        "name": "fused_step (rows + cols)", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": errs[(MAIN_SIZE, torch.bfloat16, 1)],
        "max_abs_err_fp32": errs[(MAIN_SIZE, torch.float32, 1)],
        "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
