"""Launch-plan sweep of the Stockham FFT kernels (K3 `csrc/rows_fft.cu`, K2
`csrc/rows_fft.cu` + `csrc/planes_fft.cu`, K1 `csrc/fused_step.cu`) on one
CUDA card.

    python -m godotoceanwaves_tpu_torch.utils.fft_sweep

From the checkout root. Builds the kernels and prints the ptxas lines of the
Stockham kernels (registers, spills); holds K3 and K2, through their
wrappers, against `torch.fft` at every power of two N = 16..8192 and both
fold_sign values (<= 1e-4 relative RMS); then times, with CUDA events, each
kernel under a few launch plans (threads a block) at the main path's
shapes: K3 at the config-5 shard (16, 2, 1024, 2048), K2 at 16 x 1024^2 and
8 x 2048^2 (also with other record widths, and over 1, 2 or 4 planes at a
time), beside `torch.fft.ifft` / `torch.fft.ifft2` on the same planes, a
`copy_` of the same planes (the bytes without the arithmetic) and the bytes
bound (16 bytes an element over 3.35 TB/s); K1's row pass and column pass
at config 4 (4 x 1024^2, bf16 maps) under a few plans, each plan's maps
equal to the default plan's. Prints the card's name and power limit and
one JSON line of the times. Exits non-zero without a card or when a check
fails.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from ..ops import _build, fft, fft_plan, fused_step, planes_fft, rows_fft
from .timing import time_cuda

HBM_TBPS = 3.35
TOL = 1e-4


def rel_rms(got, ref) -> float:
    d = (got.double() - ref.double()).pow(2).mean().sqrt()
    return float(d / ref.double().pow(2).mean().sqrt().clamp_min(1e-300))


def rows_call(lib, x, out, plan, tile=0, fold=True):
    l, _, r, n = x.shape
    tw = fft_plan.twiddles(n, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return lambda: lib.rows_fft(x.data_ptr(), out.data_ptr(), tw.data_ptr(), l, r, n, int(fold),
                                plan.seqs, plan.pitch, tile, stream)


def cols_call(lib, mid, out, plan, fold=True, tile=fft_plan.TILE):
    l, _, n, _ = out.shape
    tw = fft_plan.twiddles(n, out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    return lambda: lib.planes_fft_cols(mid.data_ptr(), out.data_ptr(), tw.data_ptr(), l, n,
                                       int(fold), plan.seqs, plan.pitch, tile, stream)


def check_all(dev) -> dict:
    errs = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    n = fft_plan.MIN_N
    while n <= fft_plan.MAX_N:
        x = torch.randn((2, 2, 37, n), generator=gen, device=dev)
        p = torch.randn((2, 2, n, n), generator=gen, device=dev)
        for fold in (False, True):
            e3 = rel_rms(rows_fft.idft_rows_planes(x, fold), fft.idft_rows_planes(x, fold))
            e2 = rel_rms(planes_fft.ifft2_packed_planes(p, fold), fft.ifft2_packed_planes(p, fold))
            errs[f"{n}/{int(fold)}"] = (e3, e2)
            print(f"N={n} fold_sign={fold}: K3 rel RMS {e3:.3e}, K2 rel RMS {e2:.3e}", flush=True)
            if max(e3, e2) > TOL:
                raise SystemExit(f"FAIL: N={n} fold_sign={fold} disagrees with torch.fft")
        n *= 2
    return errs


def sweep(lib, dev) -> dict:
    out = {}
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((16, 2, 1024, 2048), generator=gen, device=dev)
    y = torch.empty_like(x)
    z = torch.complex(x[:, 0], x[:, 1])
    moved = 2 * x.numel() * 4
    lib_ms = time_cuda(lambda: torch.fft.ifft(z, dim=-1, norm="forward"))
    k3 = {}
    for threads in (128, 256, 512):
        plan = fft_plan.rows_plan(2048, threads)
        k3[threads] = time_cuda(rows_call(lib, x, y, plan), iters=50)
    copy_ms = time_cuda(lambda: y.copy_(x), iters=50)   # the same bytes, no arithmetic
    out["K3 (16, 2, 1024, 2048)"] = dict(ms_by_threads=k3, torch_fft_ifft_ms=lib_ms,
                                         copy_ms=copy_ms, bound_ms=moved / HBM_TBPS / 1e9)
    del x, y, z
    for l, n in ((16, 1024), (8, 2048)):
        x = torch.randn((l, 2, n, n), generator=gen, device=dev)
        mid, y = torch.empty_like(x), torch.empty_like(x)
        z = torch.complex(x[:, 0], x[:, 1])
        lib_ms = time_cuda(lambda: torch.fft.ifft2(z, norm="forward"))
        rows_ms = {t: time_cuda(rows_call(lib, x, mid, fft_plan.rows_plan(n, t), fft_plan.TILE,
                                          False), iters=50) for t in (128, 256, 512)}
        cols_ms = {t: time_cuda(cols_call(lib, mid, y, fft_plan.cols_plan(n, t)), iters=50)
                   for t in (128, 256, 512)}
        pair_ms = time_cuda(lambda: planes_fft.ifft2_packed_planes(x, True), iters=50)
        want = planes_fft.ifft2_packed_planes(x, True)
        widths = {}
        for tile in (2, 4, 8, 16):        # record width of the intermediate
            for t in (256, 512):
                r_c = rows_call(lib, x, mid, fft_plan.rows_plan(n), tile, False)
                c_c = cols_call(lib, mid, y, fft_plan.cols_plan(n, t), True, tile)
                y.zero_()
                r_c()
                c_c()
                widths[f"{tile}/{t}"] = (time_cuda(r_c, iters=50), time_cuda(c_c, iters=50),
                                         rel_rms(y, want))
                print(f"K2 {l} x {n}^2 records of {tile}, {t}-thread columns: {widths[f'{tile}/{t}']}",
                      flush=True)
        # the pair over a few planes at a time, one intermediate reused, so
        # the column pass may read what the row pass just wrote from L2
        chunked = {}
        for lc in (1, 2, 4):
            part = torch.empty_like(x[:lc])
            rows_c = [rows_call(lib, x[i:i + lc], part, fft_plan.rows_plan(n), fft_plan.TILE,
                                False) for i in range(0, l, lc)]
            cols_c = [cols_call(lib, part, y[i:i + lc], fft_plan.cols_plan(n))
                      for i in range(0, l, lc)]

            def run():
                for a, b in zip(rows_c, cols_c):
                    a()
                    b()
            y.zero_()
            run()
            chunked[lc] = (time_cuda(run, iters=50), rel_rms(y, want))
            print(f"K2 {l} x {n}^2 in chunks of {lc} planes: {chunked[lc]}", flush=True)
        out[f"K2 {l} x {n}^2"] = dict(rows_ms_by_threads=rows_ms, cols_ms_by_threads=cols_ms,
                                      pair_ms=pair_ms, chunked_ms_rel_rms=chunked,
                                      rows_cols_ms_rel_rms_by_width=widths,
                                      torch_fft_ifft2_ms=lib_ms,
                                      bound_ms=2 * x.numel() * 4 / HBM_TBPS / 1e9)
        del x, mid, y, z
    return out


def sweep_step(lib, dev) -> dict:
    """K1's two passes at config 4 (bench.py's 4 cascades at 1024^2, bf16
    maps) under plans of 256 and 512 threads a block (1 or 2 rows or
    columns at 1024)."""
    from ..models import default_cascades, init_state, SimConfig
    from ..models.ocean import _foam_rates
    n = 1024
    base = default_cascades(device=dev)
    params = base.map(lambda x: torch.cat([x, x[:1]]))
    st = init_state(SimConfig(map_size=n), params)
    grow, decay = _foam_rates(params, 0.02)
    scal = fused_step.pack_scalars(st.time + 0.02, params.tile_length, params.whitecap, grow,
                                   decay)
    c = params.num_cascades
    want = fused_step.fused_cascade_step(st.h0, st.h0nc, st.omega, st.foam, scal)
    tw = fft_plan.twiddles(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = torch.empty((c, n, n, 2 * fft_plan.LAYERS), device=dev)
    disp, normal = torch.empty_like(want[0]), torch.empty_like(want[1])
    foam = torch.empty_like(st.foam)

    def rows(plan):
        return lambda: lib.fused_step_rows(
            st.h0.data_ptr(), st.h0nc.data_ptr(), st.omega.data_ptr(), scal.data_ptr(),
            tw.data_ptr(), scratch.data_ptr(), c, n, 0, plan.lines, plan.pitch, plan.join_pitch,
            stream)

    def cols(plan):
        return lambda: lib.fused_step_cols(
            scratch.data_ptr(), st.foam.data_ptr(), scal.data_ptr(), tw.data_ptr(),
            disp.data_ptr(), normal.data_ptr(), foam.data_ptr(), c, n, 1, disp.stride(0),
            normal.stride(0), plan.lines, plan.pitch, plan.join_pitch, stream)

    out = {"rows_ms_by_threads": {}, "cols_ms_by_threads": {}}
    for t in (256, 512):
        plan = fft_plan.step_rows_plan(n, t)
        if rows(plan)() or cols(fft_plan.step_cols_plan(n))():
            raise SystemExit(f"FAIL: K1 with a {t}-thread row plan did not launch")
        if not all(torch.equal(a, b) for a, b in zip((disp, normal, foam), want)):
            raise SystemExit(f"FAIL: K1 with a {t}-thread row plan differs from the default")
        out["rows_ms_by_threads"][t] = time_cuda(rows(plan), iters=50)
    for t in (256, 512):
        plan = fft_plan.step_cols_plan(n, t)
        if cols(plan)():
            raise SystemExit(f"FAIL: K1 with a {t}-thread column plan did not launch")
        if not all(torch.equal(a, b) for a, b in zip((disp, normal, foam), want)):
            raise SystemExit(f"FAIL: K1 with a {t}-thread column plan differs from the default")
        out["cols_ms_by_threads"][t] = time_cuda(cols(plan), iters=50)
    out["pair_ms"] = time_cuda(lambda: fused_step.fused_cascade_step(
        st.h0, st.h0nc, st.omega, st.foam, scal), iters=50)
    print(f"K1 {c} x {n}^2 bf16: {out}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fft_sweep: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    path, log = _build.compile_library()
    keep = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("rows_fft", "planes_cols", "step_rows", "step_cols"))
        if keep and any(k in line for k in ("entry function", "registers", "spill")):
            print("ptxas:", line.strip())
    lib = _build.load()
    errs = check_all(dev)
    times = sweep(lib, dev)
    times["K1 4 x 1024^2 bf16"] = sweep_step(lib, dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "times": times, "max_rel_rms": max(max(v) for v in
                                                                       errs.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
