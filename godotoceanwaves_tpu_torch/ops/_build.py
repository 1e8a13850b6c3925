"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` is compiled with `nvcc` for sm_90a, all of them at once in
parallel processes, and the objects are linked into one shared library with
a plain C interface. That happens at first use (never at import), in the
git-ignored `build/` directory beside the package, and the library is loaded
with ctypes. The library name carries a hash of the sources and headers, so
an edited kernel is rebuilt. One lock guards the first load, so two threads
that launch kernels at the same time (a viewer's frame loop and its
reconfiguration worker) run one build between them.

Package code launches a kernel through `launch` alone: it calls the
library's symbol, raises on the CUDA error it returns, and counts one launch
of the op (`fused_step`, `strip_step`, `planes_fft`, `rows_fft`, `tap`,
`march`, `splat`, `fan`, `spray`) in `LAUNCHES` and in the trace counter
`launches.<op>`. A launch that a thread records into a CUDA graph
(`recording`, set by `utils/graphs.py` around a capture) is not made: it
goes to the capture's tally, and each replay counts that tally (`made`).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..utils.observability import count

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Per-source flags. The render kernels round interpolation weights to bf16,
# so a contracted multiply-add that moves a weight by an ulp can flip its
# rounding, and the fan select and the spray step must round as their plain
# chains' separate launches do: they build without contraction.
SOURCE_FLAGS = {"tap.cu": ("-fmad=false",), "march.cu": ("-fmad=false",),
                "splat.cu": ("-fmad=false",), "fan.cu": ("-fmad=false",),
                "spray.cu": ("-fmad=false",)}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
_PP = ctypes.POINTER(ctypes.c_void_p)
_FP = ctypes.POINTER(ctypes.c_float)
_LLP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # fused_step_rows(h0, h0nc, omega, scal, tw, scratch, c, n, frame, rows, pitch, jpitch,
    #                 stream)
    "fused_step_rows": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # fused_step_cols(scratch, foam_in, scal, tw, disp, normal, foam_out, c, n,
    #                 dtype, disp_cstride, norm_cstride, cols, pitch, jpitch, stream)
    "fused_step_cols": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _P),
    # fused_step_stream(&stream)
    "fused_step_stream": (_PP,),
    # strip_step_rows(h0, h0nc, omega, scal, tw, twn, scratch, c, n, rows, pitch, jpitch,
    #                 stream)
    "strip_step_rows": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # strip_step_cols(scratch, foam_in, scal, tw, twn, disp, normal, foam_out, c, n,
    #                 dtype, disp_cstride, norm_cstride, cols, pitch, jpitch, stream)
    "strip_step_cols": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _P),
    # planes_fft_cols(mid, out, tw, l, n, fold_sign, cols, pitch, tile, stream)
    "planes_fft_cols": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # rows_fft(x, out, tw, l, r, n, fold_sign, seqs, pitch, tile, stream)
    "rows_fft": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # lod_tap(levels_ptrs, nlev, bf16, scales, xz, xz_band, xz_pixel, xz_comp, band_levels,
    #         out, bands, pixels, cascades, res, stream)
    "lod_tap": (_PP, _I, _I, _P, _P, _LL, _LL, _LL, _P, _P, _I, _I, _I, _I, _P),
    # march_heightfield(table, bf16, row, col, compact, dirs, t0, t1, valid, cam, center, org,
    #                   inv_cell, found, lo, hi, pixels, g, steps, inv_steps, rounds, stream)
    "march_heightfield": (_P, _I, _LL, _LL, _P, _P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _I,
                          _I, _I, _F, _I, _P),
    # splat_spray(img, x, y, z, dist, world_r, scales, dissolve, visible, custom_z, turns,
    #             tan_half, focal, boost, table, lobes, particles, h, w, aspect, max_alpha,
    #             recs, rects, tiles, lists, capacity, out, stream)
    "splat_spray": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I,
                    _F, _F, _P, _P, _P, _P, _LL, _P, _P),
    # fan_bracket(hfan, tau, i0, w0, w1, s, t0, t1, dxz, marchable, cam_y, ratio, phi, taus, g,
    #             h, w, tsel, found, t_lo, t_hi, stream)
    "fan_bracket": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P, _P),
    # spray_step(start_pos, start_time, lifetime, custom_z, scale_factor, base_scale, active,
    #            has_started, cycle, disp, normal, strides, dtype, cascades, n, scales, now,
    #            consts, particles, grid, seed1, o_start_pos, o_start_time, o_lifetime,
    #            o_custom_z, o_scale_factor, o_base_scale, o_active, o_has_started, o_cycle,
    #            position, scale, dissolve, visible, stream)
    "spray_step": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LLP, _I, _I, _I, _P, _P, _FP, _I,
                   _I, _U, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha1((" ".join(NVCC_FLAGS) + repr(sorted(SOURCE_FLAGS.items()))).encode())
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgodotocean_kernels_{h.hexdigest()[:12]}.so"


def compile_library() -> tuple[Path, str]:
    """Compile the kernels if the library is missing; returns (path, nvcc log)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in SOURCES]
        compiles = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", "-o", obj,
                     str(src)]
                    for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        outs = [proc.communicate()[0] for proc in procs]   # every process ends here
        for cmd, proc, out in zip(compiles, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        text = "".join(outs)
        link = [nvcc, "-shared", "-o", str(Path(tmp) / "lib.so"), *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}\n"
                               f"{proc.stdout}{proc.stderr}")
        # atomic: another process never loads a half-written library
        os.replace(Path(tmp) / "lib.so", path)
    return path, text


_LOAD_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    path, _ = compile_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# Kernel launches made, by op, since the process started or the last
# `LAUNCHES.clear()`; a launch captured in a CUDA graph counts at each replay.
LAUNCHES: collections.Counter = collections.Counter()
_recording = threading.local()   # .tally: the Counter of the graph this thread captures


def launch(op: str, symbol: str, *args) -> None:
    """Call the library's `symbol` with `args`, raise if it returns a CUDA
    error, and count one launch of `op`."""
    rc = getattr(load(), symbol)(*args)
    if rc:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
    tally = getattr(_recording, "tally", None)
    if tally is None:
        LAUNCHES[op] += 1
        count("launches." + op)
    else:
        tally[op] += 1


def made(tally) -> None:
    """Count the launches of `tally` ({op: n}) as made: a graph's replay."""
    for op, n in tally.items():
        LAUNCHES[op] += n
        count("launches." + op, n)


@contextlib.contextmanager
def recording(tally: collections.Counter):
    """This thread's launches in the block go to `tally` and count nowhere
    else: a graph capture records its launches without making them."""
    _recording.tally = tally
    try:
        yield
    finally:
        _recording.tally = None
