"""Build and load the package's CUDA kernels.

`csrc/*.cu` is compiled with `nvcc` for sm_90a into a shared library with a
plain C interface, at first use (never at import), into the git-ignored
`build/` directory beside the package, and loaded with ctypes. The library
name carries a hash of the sources, so an edited kernel is rebuilt.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # fused_step_rows(h0, h0nc, omega, scal, scratch, c, n, frame, stream)
    "fused_step_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # fused_step_cols(scratch, foam_in, scal, disp, normal, foam_out, c, n,
    #                 dtype, disp_cstride, norm_cstride, stream)
    "fused_step_cols": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P),
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
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgodotocean_kernels_{h.hexdigest()[:12]}.so"


def compile_library() -> tuple[Path, str]:
    """Compile the kernels if the library is missing; returns (path, nvcc log)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: another process never loads a half-written library
    return path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    path, _ = compile_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
