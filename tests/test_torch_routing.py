"""Which tier a step takes, by map size: the port's gates against the JAX
package's, `_synthesize`'s choice, and the wrappers' own size limits.

The port routes as the JAX package does (its cascade.py:199-249), with the
card's ranges: fused kernel for 16 <= N <= 1024, strip kernel for
1024 < N <= 8192, the staged path for every other N (4 and 8 included) and
with fused="never". Within 16..8192 the staged path's FFT is the planes
kernel's wrapper; outside, torch.fft.
"""
import numpy as np
import pytest
import torch

import godotoceanwaves_tpu as J

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import ocean as tocean
from godotoceanwaves_tpu_torch.ops import fft, fused_step, planes_fft, strip_step

# the cases of tests/test_pallas_strip.py::test_use_strip_step_gating
STRIP_CASES = [dict(map_size=2048), dict(map_size=4096), dict(map_size=8192),
               dict(map_size=1024), dict(map_size=16384),
               dict(map_size=2048, fused="never"), dict(map_size=2048, map_dtype="float16")]


@pytest.mark.parametrize("case", STRIP_CASES, ids=lambda c: "-".join(map(str, c.values())))
def test_gates_match_jax(case):
    """Against the JAX answers with the Pallas tier requested (its TPU
    routing): the strip gate everywhere, and the fused gate at N >= 128."""
    jcfg, tcfg = J.SimConfig(fft_impl="pallas", **case), T.SimConfig(**case)
    assert tcfg.use_strip_step() == jcfg.use_strip_step()
    assert tcfg.use_fused_step() == jcfg.use_fused_step()


@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_fused_gate_matches_jax(n):
    for fused in ("auto", "never"):
        assert (T.SimConfig(map_size=n, fused=fused).use_fused_step()
                == J.SimConfig(map_size=n, fused=fused, fft_impl="pallas").use_fused_step())


class Chosen(Exception):
    pass


@pytest.mark.parametrize("n,fused,want", [
    (8, "auto", "torch.fft"), (16, "auto", "fused"), (1024, "auto", "fused"),
    (2048, "auto", "strip"), (8192, "auto", "strip"),
    (4, "never", "torch.fft"), (16, "never", "planes_fft"), (2048, "never", "planes_fft"),
    (8192, "never", "planes_fft"), (16384, "never", "torch.fft")])
def test_synthesize_picks_the_tier(monkeypatch, n, fused, want):
    """Each candidate is replaced by a stub that names itself; the inputs are
    tiny because the stubs never look at them."""
    for module, name, label in [(fused_step, "fused_cascade_step", "fused"),
                                (strip_step, "strip_cascade_step", "strip"),
                                (planes_fft, "ifft2_packed_planes", "planes_fft"),
                                (fft, "ifft2_packed_planes", "torch.fft")]:
        def stub(*args, label=label, **kwargs):
            raise Chosen(label)
        monkeypatch.setattr(module, name, stub)
    cfg = T.SimConfig(map_size=n, fused=fused)
    params = T.default_cascades(device="cpu").map(lambda x: x[:1])
    z = lambda *shape: torch.zeros(shape)
    with pytest.raises(Chosen) as chosen:
        tocean._synthesize(cfg, z(1, 2, 4, 4), z(1, 2, 4, 4), z(1, 4, 4), z(1, 4, 4), params,
                           torch.ones(1), 0.02)
    assert str(chosen.value) == want
    assert cfg.step_tier() == {"torch.fft": "staged", "planes_fft": "staged"}.get(want, want)


@pytest.mark.parametrize("module,n", [(fused_step, 2048), (fused_step, 8), (strip_step, 1024),
                                      (strip_step, 16384)])
def test_kernel_steps_raise_outside_their_sizes(module, n):
    """The CUDA path refuses N outside its range before any build (a build
    here, with no nvcc, would raise RuntimeError instead)."""
    z = lambda *shape: torch.zeros(()).expand(shape)     # no memory behind it
    args = (z(1, 2, n, n), z(1, 2, n, n), z(1, n, n), z(1, n, n), z(1, 1, fused_step.NUM_SCALARS))
    kwargs = dict(num_frames=1, map_dtype=torch.float32, multi=False) if module is fused_step \
        else dict(map_dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="power-of-two N"):
        module._launch(*args, **kwargs)


@pytest.mark.parametrize("n", [8, 16384])
def test_planes_fft_raises_outside_its_sizes(n):
    with pytest.raises(NotImplementedError, match="power-of-two N"):
        planes_fft._launch(torch.zeros(()).expand(1, 2, n, n), True)


def test_resize_across_1024_switches_tiers(monkeypatch):
    """One cascade resized 1024 -> 2048 -> 512: the strip step runs at 2048,
    the fused step on either side, and the maps follow the new size."""
    calls = []
    for module, name in [(fused_step, "fused_cascade_step"), (strip_step, "strip_cascade_step")]:
        original = getattr(module, name)

        def counting(*args, original=original, name=name, **kwargs):
            calls.append(name)
            return original(*args, **kwargs)
        monkeypatch.setattr(module, name, counting)
    ocean = T.Ocean(params=T.default_cascades(device="cpu").map(lambda x: x[:1]), map_size=1024,
                    updates_per_second=0, device="cpu")
    for n, tier in [(1024, "fused_cascade_step"), (2048, "strip_cascade_step"),
                    (512, "fused_cascade_step")]:
        if n != ocean.config.map_size:
            ocean.resize(n)
        calls.clear()
        maps = ocean.update(0.02)
        assert calls == [tier]
        assert maps.displacement.shape == (1, 3, n, n)
        assert bool(maps.displacement.isfinite().all())
        assert np.ptp(maps.displacement[0, 1].numpy()) > 0
