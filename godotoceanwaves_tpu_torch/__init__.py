"""godotoceanwaves_tpu_torch — the PyTorch / CUDA port of godotoceanwaves_tpu.

Mirrors the JAX package's module layout and public names. The per-frame
step (modulate -> Hermitian-packed 2D IFFT -> unpack + foam) runs on a CUDA
device through hand-written kernels (`csrc/fused_step.cu` for N <= 1024,
`csrc/strip_step.cu` for 2048 <= N <= 8192, both on the pass bodies of
`csrc/step_passes.cuh`; `csrc/rows_fft.cu` + `csrc/planes_fft.cu` as the
staged path's FFT, `csrc/rows_fft.cu` alone as the row-sharded FFT's local
pass in `parallel`; all of them on the register-resident Stockham core
`csrc/stockham.cuh`), and on the CPU through their plain PyTorch versions.
Imports `torch`, never `jax`.
"""
from . import models, ops, parallel
from .models import (
    CascadeParams,
    Ocean,
    OceanMaps,
    OceanState,
    SimConfig,
    default_cascades,
    init_state,
    simulate,
    step,
)

__version__ = "0.1.0"
__all__ = [
    "ops", "models", "parallel", "CascadeParams", "Ocean", "OceanMaps", "OceanState",
    "SimConfig", "default_cascades", "init_state", "simulate", "step",
]
