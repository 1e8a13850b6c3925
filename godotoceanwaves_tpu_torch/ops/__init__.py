"""Compute ops: the reference's GLSL kernels in PyTorch, plus the fused CUDA step.

Stage map (reference file -> module):
  spectrum_compute.glsl  -> initial_state (+ spectra, rng, grid)
  spectrum_modulate.glsl -> modulate
  fft_butterfly/fft_compute/transpose.glsl -> fft (torch.fft)
  fft_unpack.glsl        -> unpack
  all of the per-frame chain -> fused_step (csrc/fused_step.cu on the card)
"""
from . import fft, fused_step, grid, initial_state, modulate, rng, spectra, unpack

__all__ = ["fft", "fused_step", "grid", "initial_state", "modulate", "rng",
           "spectra", "unpack"]
