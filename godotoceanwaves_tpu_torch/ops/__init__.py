"""Compute ops: the reference's GLSL kernels in PyTorch, plus the fused CUDA step.

Stage map (reference file -> module):
  spectrum_compute.glsl  -> initial_state (+ spectra, rng, grid)
  spectrum_modulate.glsl -> modulate
  fft_butterfly/fft_compute/transpose.glsl -> fft (torch.fft)
  fft_unpack.glsl        -> unpack
  all of the per-frame chain -> fused_step (csrc/fused_step.cu on the card, N <= 1024)
                             -> strip_step (csrc/strip_step.cu, 2048 <= N <= 8192)
                                (both on the pass bodies of csrc/step_passes.cuh)
  the staged path's 2D IFFT  -> planes_fft (csrc/rows_fft.cu + csrc/planes_fft.cu, 16 <= N <= 8192)
  the row-sharded IFFT's shard-local pass -> rows_fft (csrc/rows_fft.cu, 16 <= N <= 8192)
  the launch plans and twiddle tables of all four -> fft_plan (csrc/stockham.cuh)
  the render's LOD gradient taps -> tap (csrc/tap.cu)
  the render's heightfield march (march_impl="pallas") -> march (csrc/march.cu)
"""
from . import (fft, fft_plan, fused_step, grid, initial_state, march, modulate, planes_fft,
               rng, rows_fft, spectra, strip_step, tap, unpack)

__all__ = ["fft", "fft_plan", "fused_step", "grid", "initial_state", "march", "modulate",
           "planes_fft", "rng", "rows_fft", "spectra", "strip_step", "tap", "unpack"]
