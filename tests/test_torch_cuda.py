"""The port's CUDA kernels on the card. Every test here is marked `cuda` and
skips where no CUDA device is present.

This file imports only numpy, torch and the port, so it runs where the JAX
package cannot be imported. From the checkout root on a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances are those of the kernel-vs-plain check in chip_smoke.py: fp32
maps <= 1e-4 relative RMS, 2-byte maps <= 1e-3 (displacement, relative) and
<= 2e-3 (normal, RMS), foam <= 1e-4 RMS; the gradient taps (K5) <= 5e-5 max
abs; the march (K6) `found` equal on >= 99.9 % of pixels and lo/hi within
1e-4 relative; a rendered frame, kernel route vs plain route, <= 1e-3 mean;
the planes IFFT (K2) and the rows DFT (K3) <= 1e-4 relative RMS against
torch.fft at every N = 16..8192; the spray splat on the card vs the CPU
<= 2e-3 max abs (both round the composite's operands to bf16), and the splat
kernel vs the plain route on the card <= 1e-4 max abs (the same products,
summed in another order); the fan march's bracket select and the spray step
bit-equal to their plain routes. The browser
viewer serves frames from the card over localhost as standard-library PNGs.
The captured frame programs (utils/graphs.py) replay bit-equal to the same
programs run eagerly inside `graphs.disabled()`.
"""
import contextlib
import dataclasses
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models.ocean import _foam_rates
from godotoceanwaves_tpu_torch.models import geometry, shading
from godotoceanwaves_tpu_torch.models.viewport import (RENDER_TIERS, FramePipeline, SceneRenderer,
                                                       SpraySession, make_batched_step)
from godotoceanwaves_tpu_torch import parallel
from godotoceanwaves_tpu_torch.ops import (fan, fft, fused_step, march, planes_fft, rows_fft,
                                           splat, strip_step, tap)
from godotoceanwaves_tpu_torch.ops._build import LAUNCHES
from godotoceanwaves_tpu_torch.utils import graphs

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def rel_rms(got, ref) -> float:
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt().clamp_min(1e-12))


def rms(got, ref) -> float:
    return float((got.double().cpu() - ref.double().cpu()).pow(2).mean().sqrt())


def assert_close(got, want, two_byte: bool):
    (d, nm, foam), (wd, wn, wfoam) = got, want
    if two_byte:
        assert rel_rms(d, wd) <= 1e-3 and rms(nm, wn) <= 2e-3
    else:
        assert rel_rms(d, wd) <= 1e-4 and rel_rms(nm, wn) <= 1e-4
    assert rms(foam, wfoam) <= 1e-4


def inputs(n: int, dev, multi: bool, cascades: int = 3):
    params = T.default_cascades(device=dev).map(lambda x: x[:cascades])
    state = T.init_state(T.SimConfig(map_size=n), params)
    rng = np.random.default_rng(n)
    foam = torch.from_numpy(rng.uniform(0, 0.5, (cascades, n, n)).astype(np.float32)).to(dev)
    grow, decay = _foam_rates(params, 0.1)
    scal = fused_step.pack_scalars(state.time + 0.1, params.tile_length, params.whitecap,
                                   grow, decay, dt=0.1 if multi else None)
    return state.h0, state.h0nc, state.omega, foam, scal


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_multi_step_kernel_matches_plain(card, dtype):
    args = inputs(128, card, multi=True)
    before = LAUNCHES["fused_step"]
    got = fused_step.fused_cascade_multi_step(*args, num_frames=2, map_dtype=DTYPES[dtype])
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] == before + 4
    want = fused_step.fused_cascade_multi_step_reference(*args, num_frames=2,
                                                         map_dtype=DTYPES[dtype])
    assert got[0].dtype == DTYPES[dtype] and got[0].shape == (3, 2, 3, 128, 128)
    for k in range(2):
        assert_close((got[0][:, k], got[1][:, k], got[2]),
                     (want[0][:, k], want[1][:, k], want[2]), two_byte=dtype != "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1 << b for b in range(4, 11)])
def test_step_kernel_matches_plain_across_sizes(card, n, dtype):
    """K1 at every N = 16..1024 and map dtype: fp32 maps <= 1e-4 relative
    RMS; 2-byte maps <= 1e-3 (displacement) and <= 2e-3 (normal, RMS); foam
    <= 1e-4 RMS."""
    args = inputs(n, card, multi=False)
    before = LAUNCHES["fused_step"]
    got = fused_step.fused_cascade_step(*args, map_dtype=DTYPES[dtype])
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] == before + 2
    want = fused_step.fused_cascade_step_reference(*args, map_dtype=DTYPES[dtype])
    assert got[0].dtype == DTYPES[dtype] and got[0].shape == (3, 3, n, n)
    assert_close(got, want, two_byte=dtype != "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_step_kernel_at_1024_carries_foam_in_place(card, dtype):
    """Three frames at 1024^2, foam read and written in place from frame 1
    on: every frame and the final foam within the tolerances above."""
    args = inputs(1024, card, multi=True)
    got = fused_step.fused_cascade_multi_step(*args, num_frames=3, map_dtype=DTYPES[dtype])
    want = fused_step.fused_cascade_multi_step_reference(*args, num_frames=3,
                                                         map_dtype=DTYPES[dtype])
    for k in range(3):
        assert_close((got[0][:, k], got[1][:, k], got[2]),
                     (want[0][:, k], want[1][:, k], want[2]), two_byte=dtype != "float32")


def config4_inputs(dev, frames: int):
    """Config 4's step inputs: the scene's three cascades and its cascade 0
    again at 1024^2, seeded foam, the scalar rows of `step_frames` at dt 0.02."""
    base = T.default_cascades(device=dev)
    params = base.map(lambda x: torch.cat([x, x[:1]]))
    state = T.init_state(T.SimConfig(map_size=1024), params)
    rng = np.random.default_rng(frames)
    foam = torch.from_numpy(rng.uniform(0, 0.5, (4, 1024, 1024)).astype(np.float32)).to(dev)
    grow, decay = _foam_rates(params, 0.02)
    scal = fused_step.pack_scalars(state.time + 120.0, params.tile_length, params.whitecap,
                                   grow, decay, dt=0.02)
    return state.h0, state.h0nc, state.omega, foam, scal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipelined_multi_frame_launch_is_bit_equal_to_the_pairs_in_turn(card, dtype):
    """Config 4 (C = 4, N = 1024): the multi-frame launch, its row passes on
    a stream of their own running ahead of the column passes, against the
    batched pair run a frame at a time. One frame equals
    `fused_cascade_step`; six frames equal six `fused_cascade_step` calls at
    t0 + k dt in turn, foam chained, and the same call on each cascade's
    slice alone: maps and final foam, bit for bit, 2 launches a frame."""
    mdt = DTYPES[dtype]
    h0, h0nc, omega, foam, scal = args = config4_inputs(card, 6)
    d1, n1, f1 = fused_step.fused_cascade_multi_step(*args, num_frames=1, map_dtype=mdt)
    d, nm, f = fused_step.fused_cascade_step(*args, map_dtype=mdt)
    assert torch.equal(d1[:, 0], d) and torch.equal(n1[:, 0], nm) and torch.equal(f1, f)
    before = LAUNCHES["fused_step"]
    got = fused_step.fused_cascade_multi_step(*args, num_frames=6, map_dtype=mdt)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] == before + 2 * 6
    f = foam
    for k in range(6):
        single = scal.clone()
        single[:, 0, fused_step.S_TIME] = (scal[:, 0, fused_step.S_TIME]
                                           + scal[:, 0, fused_step.S_DT] * float(k))
        d, nm, f = fused_step.fused_cascade_step(h0, h0nc, omega, f, single, map_dtype=mdt)
        assert torch.equal(got[0][:, k], d) and torch.equal(got[1][:, k], nm)
    assert torch.equal(got[2], f)
    for i in range(4):
        alone = fused_step.fused_cascade_multi_step(*(a[i:i + 1] for a in args), num_frames=6,
                                                    map_dtype=mdt)
        assert all(torch.equal(g[i:i + 1], a) for g, a in zip(got, alone))


def test_step_kernel_makes_no_host_sync(card):
    """Two K1 frames at 1024^2 (bf16 maps), plans and twiddle table
    included, under set_sync_debug_mode("error"): no host sync, 2 launches a
    frame, and the tolerances above against the plain version."""
    args = inputs(1024, card, multi=True)
    torch.cuda.synchronize()
    before = LAUNCHES["fused_step"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fused_step.fused_cascade_multi_step(*args, num_frames=2, map_dtype=torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] == before + 2 * 2
    want = fused_step.fused_cascade_multi_step_reference(*args, num_frames=2,
                                                         map_dtype=torch.bfloat16)
    for k in range(2):
        assert_close((got[0][:, k], got[1][:, k], got[2]),
                     (want[0][:, k], want[1][:, k], want[2]), two_byte=True)


@pytest.mark.parametrize("n", [8, 2048])
def test_cuda_wrapper_raises_outside_its_sizes(card, n):
    z = lambda *shape: torch.zeros(shape, device=card)
    with pytest.raises(NotImplementedError, match="pallas_strip"):
        fused_step.fused_cascade_step(z(1, 2, n, n), z(1, 2, n, n), z(1, n, n), z(1, n, n),
                                      z(1, 1, fused_step.NUM_SCALARS))


def test_ocean_on_card_matches_ocean_on_cpu(card):
    """Five updates and a 3-frame multi_step through the session on both devices."""
    from godotoceanwaves_tpu_torch.models.ocean import multi_step
    sessions = [T.Ocean(map_size=64, updates_per_second=0, device=d) for d in (card, "cpu")]
    for o in sessions:
        for _ in range(5):
            o.update(0.02)
        o.state, o.maps = multi_step(o.config, o.state, o.params, 0.02, 3)
    gpu, cpu = sessions
    assert_close((gpu.maps.displacement, gpu.maps.normal, gpu.state.foam),
                 (cpu.maps.displacement, cpu.maps.normal, cpu.state.foam), two_byte=False)
    assert torch.equal(gpu.state.time.cpu(), cpu.state.time)


@pytest.mark.parametrize("n,dtype", [(2048, "float32"), (2048, "bfloat16"), (2048, "float16"),
                                     (4096, "float32"), (8192, "bfloat16")])
def test_strip_kernel_matches_plain(card, n, dtype):
    """K4 (one cascade) at 2048, and at 4096 and 8192 through the split,
    within the tolerances above."""
    args = inputs(n, card, multi=False, cascades=1)
    before = LAUNCHES["strip_step"]
    got = strip_step.strip_cascade_step(*args, map_dtype=DTYPES[dtype])
    torch.cuda.synchronize()
    assert LAUNCHES["strip_step"] == before + 2
    want = strip_step.strip_cascade_step_reference(*args, map_dtype=DTYPES[dtype])
    assert got[0].dtype == DTYPES[dtype] and got[0].shape == (1, 3, n, n)
    assert_close(got, want, two_byte=dtype != "float32")


FFT_SIZES = [1 << b for b in range(4, 14)]     # every N the Stockham kernels take


@pytest.mark.parametrize("n", FFT_SIZES)
@pytest.mark.parametrize("fold_sign", [False, True])
def test_planes_kernel_matches_plain(card, n, fold_sign):
    """K2 (row pass + column pass) against torch.fft: <= 1e-4 relative RMS."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, 2, n, n),
                                                                  dtype=np.float32)).to(card)
    before = LAUNCHES["planes_fft"]
    got = planes_fft.ifft2_packed_planes(x, fold_sign=fold_sign)
    torch.cuda.synchronize()
    assert LAUNCHES["planes_fft"] == before + 2
    assert rel_rms(got, fft.ifft2_packed_planes(x, fold_sign=fold_sign)) <= 1e-4


def test_new_cuda_wrappers_raise_outside_their_sizes(card):
    z = lambda *shape: torch.zeros(shape, device=card)
    with pytest.raises(NotImplementedError, match="strip"):
        strip_step.strip_cascade_step(z(1, 2, 1024, 1024), z(1, 2, 1024, 1024), z(1, 1024, 1024),
                                      z(1, 1024, 1024), z(1, 1, fused_step.NUM_SCALARS))
    with pytest.raises(NotImplementedError, match="planes"):
        planes_fft.ifft2_packed_planes(z(4, 2, 8, 8))


@pytest.mark.parametrize("n", [4, 8])
def test_small_maps_run_on_card(card, n):
    """Sizes under the fused kernel's take the staged path (torch.fft)."""
    sessions = [T.Ocean(map_size=n, updates_per_second=0, device=d) for d in (card, "cpu")]
    for o in sessions:
        for _ in range(3):
            o.update(0.02)
    gpu, cpu = sessions
    assert gpu.config.step_tier() == "staged"
    assert_close((gpu.maps.displacement, gpu.maps.normal, gpu.state.foam),
                 (cpu.maps.displacement, cpu.maps.normal, cpu.state.foam), two_byte=False)


def test_config5_session_runs_strip_and_staged_kernels(card):
    """Config 5's shape (2 cascades at 2048^2, bf16 maps): the default session
    launches K4 only, the fused="never" session K2 only, and they agree."""
    kw = dict(params=T.models.dual_wind_swell_cascades(device=card), map_size=2048,
              map_dtype="bfloat16", updates_per_second=0, device=card)
    counts = []
    sessions = []
    for fused in ("auto", "never"):
        before = (LAUNCHES["strip_step"], LAUNCHES["planes_fft"], LAUNCHES["fused_step"])
        o = T.Ocean(fused=fused, **kw)
        for _ in range(3):
            o.update(0.02)
        torch.cuda.synchronize()
        counts.append(tuple(a - b for a, b in zip(
            (LAUNCHES["strip_step"], LAUNCHES["planes_fft"], LAUNCHES["fused_step"]), before)))
        sessions.append(o)
    assert counts == [(6, 0, 0), (0, 6, 0)]
    strip, staged = sessions
    assert_close((strip.maps.displacement, strip.maps.normal, strip.state.foam),
                 (staged.maps.displacement, staged.maps.normal, staged.state.foam), two_byte=True)


# --- the render's kernels: K5 (ops/tap.py) and K6 (ops/march.py) -----------

SCALES = [[1 / 88.0, 1 / 88.0, 1.0, 1.0], [1 / 57.0, 1 / 57.0, 0.75, 1.0],
          [1 / 16.0, 1 / 16.0, 0.0, 0.25]]


def lod_case(dev, r=256, levels=4, pixels=3000, seed=0):
    """Three cascades, eight bands from near to far; levels hold 0, the
    coarsest (whose blend engages bicubic) and the skip value."""
    rng = np.random.default_rng(seed)
    normal = torch.from_numpy(rng.normal(size=(3, 4, r, r)).astype(np.float32))
    pyr = shading.normal_gradient_pyramid(normal.to(dev).to(torch.bfloat16), levels=levels)
    z0 = np.array([2.0, 10.0, 30.0, 60.0, 120.0, 250.0, 500.0, 900.0])[:, None]
    xz = np.stack([rng.uniform(-300, 300, (8, pixels)), z0 + rng.uniform(0, 9, (8, pixels))], -1)
    lev = np.array([[0, 0, 0], [0, 1, 3], [1, 2, 4], [2, 3, 3], [3, 3, 2], [4, 4, 4],
                    [3, 0, 1], [2, 2, 2]], np.int32)
    return (pyr, torch.tensor(SCALES, device=dev),
            torch.from_numpy(xz.astype(np.float32)).to(dev), torch.from_numpy(lev).to(dev))


@pytest.mark.parametrize("r", [256, 1024])
def test_tap_kernel_matches_plain(card, r):
    args = lod_case(card, r=r)
    before = LAUNCHES["tap"]
    got = tap.gradient_lod_tap(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["tap"] == before + 1
    want = tap.gradient_lod_tap_reference(*args)
    assert got.shape == want.shape == (8, 3000, 3)
    assert float((got - want).abs().max()) <= 5e-5
    assert torch.equal(got[5], torch.zeros_like(got[5]))        # all skipped


def device_ops_per_call(call, name: str, calls: int = 20) -> float:
    """Device operations (kernels, copies, fills) a launch of the kernel
    whose name holds `name`, by torch.profiler (which may miss a window's
    first launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    # a span's device row (a gpu_user_annotation, its extent) is no operation
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and not e.is_user_annotation]
    launches = sum(e.count for e in rows if name in e.key)
    assert launches > calls // 2
    return sum(e.count for e in rows) / launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_kernel_reads_levels_in_place(card, dtype):
    """fp32 levels (the renderer's) and bf16 levels, each read in place:
    one device kernel a call, the same numbers from either dtype, and a
    non-contiguous xz_bands read by its strides without a copy."""
    pyr, scales, xz, lev = lod_case(card, r=1024)
    levels = [p.to(dtype) for p in pyr]
    got = tap.gradient_lod_tap(levels, scales, xz, lev)
    want = tap.gradient_lod_tap_reference(levels, scales, xz, lev)
    assert float((got - want).abs().max()) <= 5e-5
    assert torch.equal(got, tap.gradient_lod_tap([p.float() for p in levels], scales, xz, lev))
    xz_nc = torch.zeros(xz.shape[:-1] + (5,), device=card)[..., 1:4:2]
    xz_nc.copy_(xz)
    assert not xz_nc.is_contiguous()
    assert torch.equal(tap.gradient_lod_tap(levels, scales, xz_nc, lev), got)
    for x in (xz_nc, xz):
        assert device_ops_per_call(lambda: tap.gradient_lod_tap(levels, scales, x, lev),
                                   "lod_tap_kernel") == 1


def test_tap_kernel_raises_on_what_it_does_not_take(card):
    pyr, scales, xz, lev = lod_case(card)
    with pytest.raises(TypeError, match="int32"):
        tap.gradient_lod_tap(pyr, scales, xz, lev.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tap.gradient_lod_tap([p.half() for p in pyr], scales, xz, lev)
    with pytest.raises(ValueError, match="level 1"):
        tap.gradient_lod_tap([pyr[0], pyr[2]], scales, xz, lev)
    with pytest.raises(ValueError, match="is on"):
        tap.gradient_lod_tap(pyr, scales.cpu(), xz, lev)


def march_case(dev, g=256, seed=0):
    rng = np.random.default_rng(seed)
    coarse = rng.normal(0.0, 1.2, (g // 8, g // 8))
    table = torch.from_numpy((np.kron(coarse, np.ones((8, 8)))
                              + rng.normal(0.0, 0.3, (g, g))).astype(np.float32)).to(dev)
    cam = torch.tensor([1.3, 3.0, -2.7], device=dev)
    center = torch.ceil(cam[0::2])
    d = geometry.camera_rays(320, 180, -12.0, 25.0, 70.0, device=dev)
    t0 = torch.zeros(180, 320, device=dev)
    t1 = torch.full((180, 320), 250.0, device=dev)
    valid = d[..., 1] < 0.05
    return table, d, t0, t1, valid, cam, center, -256.0, 512.0 / (g - 1)


def test_march_kernel_matches_plain(card):
    args = march_case(card)
    before = LAUNCHES["march"]
    found, lo, hi = march.march_heightfield(*args, march_steps=32, refine_rounds=2)
    torch.cuda.synchronize()
    assert LAUNCHES["march"] == before + 1
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    wf, wlo, whi = march.march_heightfield(*cpu, march_steps=32, refine_rounds=2)
    found, lo, hi = found.cpu(), lo.cpu(), hi.cpu()
    assert float((found == wf).float().mean()) >= 0.999
    both = found & wf
    assert 0.1 < float(both.float().mean()) < 0.999
    for a, b in ((lo, wlo), (hi, whi)):
        assert float(((a - b).abs() / b.abs().clamp_min(1e-6))[both].max()) <= 1e-4


@pytest.mark.parametrize("layout", ["float32", "bfloat16", "float32 slice"])
def test_march_kernel_takes_fp32_and_bf16_tables(card, layout):
    """The table read in place in either dtype, or by its strides as the
    renderer's (G, G, 3)[..., 1] slice, each texel rounded to bf16: the same
    result from all three, within tolerance of the plain version, one device
    kernel a call, a bool `found`."""
    table, *rest = march_case(card)
    if layout == "float32 slice":
        tab = torch.stack([table - 1.0, table, table + 1.0], dim=-1)[..., 1]
        assert not tab.is_contiguous()
    else:
        tab = table.to(getattr(torch, layout))
    run = dict(march_steps=32, refine_rounds=2)
    got = march.march_heightfield(tab, *rest, **run)
    assert got[0].dtype == torch.bool and got[0].shape == (180, 320)
    for a, b in zip(got, march.march_heightfield(table.to(torch.bfloat16).float(), *rest, **run)):
        assert torch.equal(a, b)
    wf, wlo, whi = march.march_heightfield_reference(tab, *rest, **run)
    assert float((got[0] == wf).float().mean()) >= 0.999
    both = got[0] & wf
    for a, b in ((got[1], wlo), (got[2], whi)):
        assert float(((a - b).abs() / b.abs().clamp_min(1e-6))[both].max()) <= 1e-4
    assert device_ops_per_call(lambda: march.march_heightfield(tab, *rest, **run),
                               "march_kernel") == 1


def test_march_kernel_raises_on_what_it_does_not_take(card):
    table, *rest = march_case(card)
    with pytest.raises(ValueError, match=r"\(G, G\)"):
        march.march_heightfield(table[None], *rest)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        march.march_heightfield(table.half(), *rest)
    with pytest.raises(TypeError, match="bool"):
        march.march_heightfield(table, *rest[:3], rest[3].float(), *rest[4:])


def test_render_launches_the_kernels_and_makes_no_host_sync(card):
    """The default render on the card goes through K5 and the fan kernel
    once per frame and no K6; march_impl="pallas" launches K6 and no fan
    kernel. A warm frame makes no host sync; the kernel-route frame matches
    the plain-route frame."""
    ocean = T.Ocean(map_size=128, map_dtype="bfloat16", updates_per_second=0, device=card)
    maps = ocean.update(1 / 60)
    scales = ocean.params.map_scales()
    kw = dict(width=160, height=96, march_steps=32, bisect_steps=6, shade_res=2,
              bracket_res=128, invert_res=256, environment=True)
    geometry.render_ocean_geometry(maps, scales, **kw)            # warm the caches
    before = (LAUNCHES["tap"], LAUNCHES["march"], LAUNCHES["fan"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = geometry.render_ocean_geometry(maps, scales, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (LAUNCHES["tap"] - before[0], LAUNCHES["march"] - before[1],
            LAUNCHES["fan"] - before[2]) == (1, 0, 1)
    assert img.shape == (96, 160, 3) and bool(img.isfinite().all())
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    plain = geometry.render_ocean_geometry(maps, scales, tap_impl="einsum", **kw)
    assert float((img - plain).abs().mean()) < 1e-3
    before = (LAUNCHES["march"], LAUNCHES["fan"])
    pal = geometry.render_ocean_geometry(maps, scales, march_impl="pallas", **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["march"] - before[0], LAUNCHES["fan"] - before[1]) == (1, 0)
    assert bool(pal.isfinite().all())


# --- the row-sharded path: K3 (ops/rows_fft.py) under parallel/ -------------

@pytest.mark.parametrize("n", FFT_SIZES)
@pytest.mark.parametrize("l,r", [(3, 37), (1, 1), (1, 1023)])
@pytest.mark.parametrize("fold_sign", [False, True])
def test_rows_kernel_matches_plain(card, n, l, r, fold_sign):
    """K3 against torch.fft: <= 1e-4 relative RMS, any R (tail rows of a
    block load zeros and are not stored) and a single plane."""
    x = torch.from_numpy(np.random.default_rng(n + r).standard_normal(
        (l, 2, r, n), dtype=np.float32)).to(card)
    before = LAUNCHES["rows_fft"]
    got = rows_fft.idft_rows_planes(x, fold_sign=fold_sign)
    torch.cuda.synchronize()
    assert LAUNCHES["rows_fft"] == before + 1
    assert rel_rms(got, fft.idft_rows_planes(x, fold_sign=fold_sign)) <= 1e-4


@pytest.mark.parametrize("kernel,launches", [("rows", 1), ("planes", 2)])
def test_fft_kernels_make_no_host_sync(card, kernel, launches):
    """A call of K3 or K2, its twiddle table included, under
    set_sync_debug_mode("error"): no host sync, its launches counted, and
    <= 1e-4 relative RMS against torch.fft."""
    n = 2048
    shape = (16, 2, 64, n) if kernel == "rows" else (2, 2, n, n)
    op, call, plain = (("rows_fft", rows_fft.idft_rows_planes, fft.idft_rows_planes)
                       if kernel == "rows" else
                       ("planes_fft", planes_fft.ifft2_packed_planes, fft.ifft2_packed_planes))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape, dtype=np.float32)).to(card)
    torch.cuda.synchronize()
    before = LAUNCHES[op]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call(x, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert LAUNCHES[op] == before + launches
    assert rel_rms(got, plain(x, True)) <= 1e-4


def test_rows_kernel_raises_outside_its_sizes(card):
    with pytest.raises(NotImplementedError, match="rows"):
        rows_fft.idft_rows_planes(torch.zeros((2, 2, 4, 8), device=card))


@pytest.mark.parametrize("n,rows,cascades,module", [(256, 8, 3, fused_step),
                                                    (2048, 2, 1, strip_step)])
def test_sharded_step_on_one_card_matches_kernel_step(card, n, rows, cascades, module):
    """A (1, rows) mesh whose positions are all the card, fp32 maps: the
    sharded step launches K3 twice a position and matches `step` (K1 at
    256^2, K4 at 2048^2) on the same state."""
    cfg = T.SimConfig(map_size=n)
    base = T.default_cascades(device=card).map(lambda x: x[:cascades])
    params = parallel.multipatch_params(base, 1, seed=4)
    mesh = parallel.build_mesh([card] * rows, rows=rows)
    state = parallel.make_multichip_init(mesh, cfg)(params)
    p0 = params.map(lambda x: x[0])
    ref_state = T.init_state(cfg, p0)
    op = module.__name__.rpartition(".")[2]
    before = (LAUNCHES["rows_fft"], LAUNCHES[op])
    state, maps = parallel.make_multichip_step(mesh, cfg)(state, params, 0.02)
    ref_state, ref = T.step(cfg, ref_state, p0, 0.02)
    torch.cuda.synchronize()
    assert (LAUNCHES["rows_fft"] - before[0], LAUNCHES[op] - before[1]) == (2 * rows, 2)
    got = maps.gather(card)
    assert_close((got.displacement[0], got.normal[0], state.gather(card).foam[0]),
                 (ref.displacement, ref.normal, ref_state.foam), two_byte=False)


@pytest.mark.parametrize("n,module", [(256, fused_step), (2048, strip_step)])
def test_sharded_step_with_one_row_position_runs_the_kernel_tier(card, n, module):
    """A (2, 1) mesh of the card holding 4 patches: each position runs its
    2 x C cascades through `step` (one K1 or K4 step, 2 launches) and no K3."""
    cfg = T.SimConfig(map_size=n)
    base = T.default_cascades(device=card).map(lambda x: x[:2])
    params = parallel.multipatch_params(base, 4, seed=6)
    mesh = parallel.build_mesh([card] * 2, rows=1)
    state = parallel.make_multichip_init(mesh, cfg)(params)
    refs = [T.init_state(cfg, params.map(lambda x, p=p: x[p])) for p in range(4)]
    op = module.__name__.rpartition(".")[2]
    before = (LAUNCHES["rows_fft"], LAUNCHES[op])
    state, maps = parallel.make_multichip_step(mesh, cfg)(state, params, 0.02)
    torch.cuda.synchronize()
    assert (LAUNCHES["rows_fft"] - before[0], LAUNCHES[op] - before[1]) == (0, 4)
    got, got_state = maps.gather(card), state.gather(card)
    for p, ref_state in enumerate(refs):
        ref_state, ref = T.step(cfg, ref_state, params.map(lambda x: x[p]), 0.02)
        assert_close((got.displacement[p], got.normal[p], got_state.foam[p]),
                     (ref.displacement, ref.normal, ref_state.foam), two_byte=False)


def test_sharded_fft_raises_outside_the_rows_kernel(card):
    """No plain fallback on the card: rows of 8 are outside K3's sizes."""
    shards = [torch.zeros((1, 2, 4, 8), device=card) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="rows"):
        parallel.sharding.ifft2_planes_sharded(shards)


def test_world_one_nccl_mesh_is_bit_equal_to_one_controller(card):
    """One NCCL worker (`parallel.launch`) holding a (4, 2) mesh of cuda:0
    at 256^2 from `make_multihost_mesh`: K3 runs both row passes of every
    position (16 launches a frame), `gather_maps` goes through NCCL, and the
    maps and foam are bit-equal to one controller driving the same mesh."""
    import functools
    import pathlib
    import sys
    from godotoceanwaves_tpu_torch.utils import convert
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import graft_entry_torch
    cfg = T.SimConfig(map_size=256)
    params = parallel.multipatch_params(T.default_cascades(device=card), 4, seed=2)
    mesh = parallel.build_mesh([card] * 8, rows=2)
    state = parallel.make_multichip_init(mesh, cfg)(params)
    leaves = {k: v.cpu().numpy() for k, v in vars(params).items()}
    start = convert.state_to_numpy(state.gather("cpu"))
    out = parallel.launch.run(functools.partial(
        graft_entry_torch.sharded_frames, layout="multihost", rows=2, per_process=8,
        config={"map_size": 256}, params=leaves, state=start, frames=2), 1, devices=[card],
        timeout_s=300)
    assert out["owners"] == [[0, 0]] * 4 and out["foreign"] == []
    assert out["K3_launches"] == 2 * 8 * 2
    step = parallel.make_multichip_step(mesh, cfg)
    for disp, normal, foam in out["frames"]:
        state, maps = step(state, params, 0.02)
        got = maps.gather("cpu")
        assert np.array_equal(disp, got.displacement.numpy())
        assert np.array_equal(normal, got.normal.numpy())
        assert np.array_equal(foam, state.gather("cpu").foam.numpy())


def test_nccl_refuses_a_mesh_of_cpu_positions(card):
    """No fallback: under NCCL a mesh with a CPU position raises in the
    worker, and `launch.run` raises with it."""
    import functools
    build = functools.partial(parallel.build_mesh, [(0, torch.device("cpu"))], 1)
    with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
        parallel.launch.run(build, 1, devices=[card], timeout_s=300)


def test_splat_spray_on_card_matches_cpu(card):
    """The splat's bf16-rounded operands and fp32 product on the card
    against the same function on the CPU, every particle visible."""
    gen = torch.Generator().manual_seed(11)
    p = 4096
    img = torch.rand((180, 320, 3), generator=gen)
    pos = torch.stack([torch.rand(p, generator=gen) * 60 - 30, torch.rand(p, generator=gen) * 3,
                       torch.rand(p, generator=gen) * 80 + 2], -1)
    scale = torch.rand((p, 3), generator=gen) * 1.8 + 0.2
    dissolve, custom_z = torch.rand(p, generator=gen), torch.rand(p, generator=gen)
    visible = torch.ones(p, dtype=torch.bool)
    args = (img, pos, scale, dissolve, visible)
    kw = dict(camera_pos=(0.0, 6.0, 0.0), pitch_deg=-9.0, yaw_deg=4.0)
    want = shading.splat_spray(*args, custom_z=custom_z, **kw)
    got = shading.splat_spray(*(a.to(card) for a in args), custom_z=custom_z.to(card), **kw)
    assert (want - img).abs().max() > 0.1
    assert float((got.cpu() - want).abs().max()) <= 2e-3


SPLAT_POSE = dict(camera_pos=(0.0, 6.0, 0.0), pitch_deg=-9.0, yaw_deg=4.0, fov_deg=70.0)
SPLAT_KW = dict(SPLAT_POSE, foam_color=shading.DEFAULT_FOAM_COLOR, max_alpha=0.666)


def splat_particles(p: int, seed: int):
    """A spray of p particles (CPU tensors) that meets every case the kernel
    must treat as the plain route does: culled (visible False) and behind
    the camera; near and large (sigma clamped to 2.2 px) and far and small
    (clamped to 0.6, so the puff's narrowest lobe is 0.24); centres spread
    across the frame's edges and off screen on every side."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=gen)
    z = torch.cat([u(p // 2) * 80 + 2, u(p // 8) * 4 + 1.5, u(p // 8) * 200 + 150,
                   u(p - p // 2 - p // 8 * 2) * 20 - 19])
    # x / z and y / z past the frustum's half-widths (0.70 wide, 0.39 high) on each side
    pos = torch.stack([(u(p) * 2.0 - 1.0) * z * 0.85, 6.0 + (u(p) * 2.0 - 1.0) * z * 0.5, z], -1)
    scale = u(p, 3) * 1.8 + 0.2
    scale[p // 2:p // 2 + p // 8] *= 4.0
    scale[p // 2 + p // 8:p // 2 + p // 4] *= 0.02
    return pos, scale, u(p), u(p) > 0.15, u(p)


def splat_routes(img, pos, scale, dissolve, visible, custom_z, sprite):
    """(kernel route, plain route) on the card, from the same card tensors."""
    args = (img, pos, scale, dissolve, visible)
    before = LAUNCHES["splat"]
    got = shading.splat_spray(*args, custom_z=custom_z, sprite=sprite, **SPLAT_KW)
    torch.cuda.synchronize()
    assert LAUNCHES["splat"] - before == 1                  # one kernel chain a call
    want = shading._splat_spray_plain(*args, *SPLAT_KW.values(), custom_z, sprite)
    return got, want


@pytest.mark.parametrize("sprite", ["puff", "gaussian"])
@pytest.mark.parametrize("with_custom_z", [False, True])
def test_splat_kernel_matches_the_plain_route(card, sprite, with_custom_z):
    """The splat kernel against `_splat_spray_plain` on the same card
    tensors, at a frame whose size is no multiple of the 16 px tile: max abs
    <= 1e-4 on the composite (both form the same bf16-rounded products; only
    the order of the fp32 sum differs; measured 2.4e-7 to 3.6e-7 over the
    four cases on an H100). Two calls are bit-equal."""
    pos, scale, dissolve, visible, custom_z = splat_particles(8192, seed=21)
    img = torch.rand((181, 317, 3), generator=torch.Generator().manual_seed(4))
    x, y, z, dist, world_r, tan_half, focal = shading._spray_view(pos, scale, 317, **SPLAT_POSE)
    sigma = torch.clamp(world_r * focal / torch.clamp_min(z, 0.5), 0.6, 2.2)[visible & (z > 0.5)]
    assert bool((sigma == float(np.float32(0.6))).any()) and bool((sigma == float(np.float32(2.2))).any())
    px = (x / (z * tan_half) + 1.0) * 0.5 * 317
    assert bool((px < 0).any()) and bool((px > 317).any())
    cz = custom_z.to(card) if with_custom_z else None
    tensors = [t.to(card) for t in (img, pos, scale, dissolve, visible)]
    got, want = splat_routes(*tensors, cz, sprite)
    assert float((want - tensors[0]).abs().max()) > 0.1
    assert float((got - want).abs().max()) <= 1e-4
    again, _ = splat_routes(*tensors, cz, sprite)
    assert torch.equal(again, got)


def test_splat_kernel_with_every_lobe_in_one_tile(card):
    """32768 puffs (196,608 lobes) at one point, each at the largest sigma:
    every lobe lands in the same tiles, each tile's list holds them all (its
    sort takes three passes). Faint enough that the sum stays below 1, so the
    clamp hides no difference: max abs <= 1e-4 against the plain route
    (measured 1.5e-5 on an H100: 196,608 terms a pixel in another order)."""
    p = 32768
    gen = torch.Generator().manual_seed(8)
    pos = torch.tensor([[0.4, 5.0, 3.0]]).repeat(p, 1)
    scale = torch.full((p, 3), 2.0)
    dissolve = torch.rand(p, generator=gen) * 2e-4
    img = torch.rand((72, 128, 3), generator=gen)
    tensors = [t.to(card) for t in (img, pos, scale, dissolve, torch.ones(p, dtype=torch.bool))]
    got, want = splat_routes(*tensors, None, "puff")
    overlay = (want - tensors[0]).abs().max()
    assert 0.05 < float(overlay) < 0.9
    assert float((got - want).abs().max()) <= 1e-4


def test_splat_kernel_turns_the_frame_nan_as_the_plain_route_does(card):
    """A particle whose position is NaN gives NaN lobes: the plain route's
    contraction is NaN everywhere, and so is the kernel's composite."""
    pos, scale, dissolve, visible, custom_z = splat_particles(512, seed=2)
    pos[7] = float("nan")
    img = torch.rand((40, 64, 3), generator=torch.Generator().manual_seed(1))
    got, want = splat_routes(*(t.to(card) for t in (img, pos, scale, dissolve, visible)),
                             custom_z.to(card), "puff")
    assert bool(want.isnan().all()) and bool(got.isnan().all())


# --- the fan march's bracket select (ops/fan.py) against its plain chain ----

# renders whose fan selects the kernel is held to: the frame cell's size and
# the web viewer's, a band, the inner frame of render_scale=2 (960x540, g = 6),
# a camera under the crests and a pose looking up at an all-sky frame
FAN_RENDERS = {
    "1280x720": dict(width=1280, height=720),
    "640x360": dict(width=640, height=360),
    "band 240+240 of 720": dict(width=1280, height=720, rows=(240, 240)),
    "1920x1080 render_scale=2": dict(width=1920, height=1080, render_scale=2),
    "under a crest": dict(width=640, height=360, camera_pos=(3.0, 0.2, -2.0), pitch_deg=4.0),
    "all sky": dict(width=640, height=360, pitch_deg=60.0),
}


@pytest.fixture(scope="module")
def fan_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ocean = T.Ocean(map_size=256, map_dtype="bfloat16", updates_per_second=0,
                    device=torch.device("cuda", 0))
    for _ in range(10):
        maps = ocean.update(1 / 30)
    return maps, ocean.params.map_scales()


def fan_calls(monkeypatch, render) -> list:
    """The arguments of every `fan.fan_bracket` call that `render()` makes."""
    calls, real = [], fan.fan_bracket

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(fan, "fan_bracket", spy)
    render()
    monkeypatch.setattr(fan, "fan_bracket", real)
    return calls


def fan_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_fan_routes_equal(args) -> tuple:
    """The kernel's (found, t_lo, t_hi, tsel) against the plain chain's on the
    same card tensors, bit for bit; returns the kernel's."""
    before = LAUNCHES["fan"]
    got = fan.fan_bracket(*args, with_tsel=True)
    torch.cuda.synchronize()
    assert LAUNCHES["fan"] - before == 1
    want = fan.fan_bracket_plain(*args, with_tsel=True)
    for name, a, b in zip(("found", "t_lo", "t_hi", "tsel"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(fan_bits(a), fan_bits(b)), name
    return got


@pytest.mark.parametrize("case", list(FAN_RENDERS))
def test_fan_kernel_matches_the_plain_chain_on_real_frames(card, fan_scene, monkeypatch, case):
    """Each render's fan select through the kernel equals the plain chain
    on the same inputs bit for bit: tsel, found, t_lo and t_hi."""
    maps, scales = fan_scene
    kw = dict(RENDER_TIERS["interactive"], environment=True, **FAN_RENDERS[case])
    calls = fan_calls(monkeypatch,
                      lambda: geometry.render_ocean_geometry(maps, scales, **kw))
    assert len(calls) == 1
    args = calls[0]
    found, _, _, tsel = assert_fan_routes_equal(args)
    marchable = args[9]
    g = args[5].shape[0] // args[2].shape[0]
    assert g == {"band 240+240 of 720": 8, "1920x1080 render_scale=2": 6, "1280x720": 8}.get(
        case, 4)
    if case == "all sky":
        assert not bool(marchable.any()) and not bool(found.any())
    else:
        assert bool(found.any())
    if case in ("1280x720", "640x360", "under a crest"):
        assert bool((marchable & ~found).any())       # rays that leave the window unmet
    assert bool(torch.isinf(tsel[~found]).all())


def test_fan_kernel_where_no_tau_qualifies(card, fan_scene, monkeypatch):
    """Windows that hold no tau (a point window, and windows past the far
    end): nothing found, the windows returned as they came, as the chain."""
    maps, scales = fan_scene
    kw = dict(RENDER_TIERS["interactive"], environment=True, width=640, height=360)
    args = list(fan_calls(monkeypatch,
                          lambda: geometry.render_ocean_geometry(maps, scales, **kw))[0])
    t0 = args[6]
    for t0_new, t1_new in ((t0, t0.clone()), (t0 + 2e4, t0 + 3e4)):
        args[6], args[7] = t0_new, t1_new
        found, t_lo, t_hi, _ = assert_fan_routes_equal(tuple(args))
        assert not bool(found.any())
        assert torch.equal(t_lo, t0_new) and torch.equal(t_hi, t1_new)


@pytest.mark.parametrize("case", ["random g=1", "random g=3", "random g=4", "lower", "upper",
                                  "rounding"])
def test_fan_kernel_matches_the_plain_chain_on_planted_cases(card, case):
    """tests/test_torch_fan.py's inputs on the card: NaN heights and slopes,
    NaN, empty and out-of-table windows, unmarchable pixels, and the exact
    ties at tau0, at tau1 and where rounding once would move the crossing."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import test_torch_fan as cpu
    args = (cpu.fan_case(3, g=int(case[-1])) if case.startswith("random")
            else cpu.tie_case(case))
    dev_args = tuple(a.to(card) if isinstance(a, torch.Tensor) else a for a in args)
    got = assert_fan_routes_equal(dev_args)
    twin = cpu.kernel_twin(*args)
    for a, b in zip(got, (twin[1], twin[2], twin[3], twin[0])):
        assert torch.equal(fan_bits(a.cpu()), fan_bits(torch.from_numpy(b)))


def test_fan_wrapper_raises_on_what_it_does_not_take(card, fan_scene, monkeypatch):
    """A tensor on another device than the rest, wrong shapes and wrong
    dtypes raise before any launch; CPU tensors take the plain chain,
    bit for bit, with no launch."""
    maps, scales = fan_scene
    kw = dict(RENDER_TIERS["interactive"], width=320, height=180)
    args = fan_calls(monkeypatch, lambda: geometry.render_ocean_geometry(maps, scales, **kw))[0]
    before = LAUNCHES["fan"]
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    for got, want in zip(fan.fan_bracket(*cpu), fan.fan_bracket_plain(*cpu)):
        assert got.device.type == "cpu" and torch.equal(got, want)
    bad = list(args)
    bad[5] = bad[5].cpu()
    with pytest.raises(ValueError, match="s is on cpu"):
        fan.fan_bracket(*bad)
    for i, change, exc, match in ((2, lambda t: t[:, :-1], ValueError, "i0 must be"),
                                  (7, lambda t: t[:-1], ValueError, "t1 must be"),
                                  (0, lambda t: t.half(), TypeError, "hfan must be float32"),
                                  (2, lambda t: t.int(), TypeError, "i0 must be int64"),
                                  (9, lambda t: t.float(), TypeError, "marchable must be bool")):
        bad = list(args)
        bad[i] = change(bad[i])
        with pytest.raises(exc, match=match):
            fan.fan_bracket(*bad)
    assert LAUNCHES["fan"] == before


# --- the spray step (ops/spray.py) against its plain route -----------------
# The maps it is held to: the frame cell's (3 x 1024^2 bf16), the same in
# fp32, and one cascade at 256^2; the frame cell's particle count and a
# ragged one. 120 advances at dt 1/60, then long ones that respawn every
# particle.

SPRAY_MAPS = {"3x1024-bf16": (1024, "bfloat16", 3), "3x1024-fp32": (1024, "float32", 3),
              "1x256-bf16": (256, "bfloat16", 1)}
SPRAY_DTS = (1 / 60,) * 120 + (1.7, 2.9, 0.6, 4.1)


def spray_mismatch(state, attrs, plain, want) -> list:
    """The fields and attributes that differ in any bit: (name, elements that
    differ, largest abs difference, largest difference relative to the plain
    route's magnitude)."""
    from godotoceanwaves_tpu_torch.models import spray
    pairs = [(f.name, getattr(state, f.name), getattr(plain, f.name))
             for f in dataclasses.fields(spray.SprayState)]
    pairs += [(f"attrs.{k}", attrs[k], want[k]) for k in want]
    out = []
    for name, a, b in pairs:
        bits = (lambda x: x.view(torch.int32)) if a.dtype == torch.float32 else (lambda x: x)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            d = (a.double() - b.double()).abs()
            out.append((name, int((bits(a) != bits(b)).sum()), float(d.max()),
                        float((d / b.double().abs().clamp_min(1e-30)).max())))
    return out


@pytest.mark.parametrize("maps_case", sorted(SPRAY_MAPS))
@pytest.mark.parametrize("p", [32768, 1000])
def test_spray_kernel_matches_the_plain_route(card, maps_case, p):
    """From one fresh state, the kernel route (`spray_step`) and
    `spray_step_plain` advance side by side on the same evolving maps: every
    field of the state and every attribute equal bit for bit after each
    advance (the bools and `cycle`, so every activation decision, and the
    floats); one launch of op `spray` an advance and nothing else; each
    kernel advance under `set_sync_debug_mode("error")`."""
    from godotoceanwaves_tpu_torch.models import spray
    from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
    n, dtype, cascades = SPRAY_MAPS[maps_case]
    ocean = T.Ocean(map_size=n, map_dtype=dtype, updates_per_second=0, device=card)
    for _ in range(10):
        ocean.update(1 / 30)
    scales = ocean.params.map_scales()[:cascades]
    params = spray.SprayParams(num_particles=p, emitter_extent=60.0)
    state = plain = spray.spray_init(params, device=card)
    now, started, activated = 0.0, 0, 0
    for i, dt in enumerate(SPRAY_DTS):
        full = ocean.update(1 / 60)
        maps = OceanMaps(displacement=full.displacement[:cascades],
                         normal=full.normal[:cascades])
        now += dt
        plain, want = spray.spray_step_plain(params, plain, maps, scales, np.float32(now))
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, got = spray.spray_step(params, state, maps, scales, np.float32(now))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        made = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
        assert made == {"spray": 1}, made
        assert got["custom_z"] is state.custom_z
        mismatch = spray_mismatch(state, got, plain, want)
        assert not mismatch, f"advance {i} (now {now:.4f}): {mismatch}"
        started += int(state.has_started.sum())
        activated += int(state.active.sum())
    assert int(state.cycle.min()) >= 1 and started > 0, (started, activated)


def test_frame_pipeline_on_card_returns_each_frame_once_in_order(card):
    """Frames rendered on the card come back through pinned buffers in
    order, each once, while later frames are queued; a returned array is
    the caller's own (the buffers keep rotating under it)."""
    pipe = FramePipeline()
    frames = [torch.full((36, 64, 3), i, dtype=torch.uint8, device=card) for i in range(6)]
    out = [pipe.push(f) for f in frames]
    out.append(pipe.flush())
    assert out[0] is None and pipe.flush() is None
    for i, host in enumerate(out[1:]):
        assert isinstance(host, np.ndarray) and host.shape == (36, 64, 3)
        assert (host == i).all(), i
    assert [int(h[0, 0, 0]) for h in out[1:]] == list(range(6))


def test_scene_frame_with_spray_on_card(card):
    """One scene frame with spray on the card: one K5 launch, uint8 RGB,
    no host sync in the update, the spray advance and the render."""
    ocean = T.Ocean(map_size=256, map_dtype="bfloat16", updates_per_second=0, device=card)
    maps = ocean.update(1 / 30)
    scales = ocean.params.map_scales()
    spray = SpraySession(num_particles=1024, device=card)
    spray.advance(maps, scales, 1 / 30)
    r = SceneRenderer(128, 72, mesh_quality="low", march_steps=32, bisect_steps=6,
                      shade_res=2, bracket_res=128, invert_res=256)
    cam = torch.tensor([0.0, 12.0, 0.0], device=card)
    r.render(maps, scales, ocean.water_color, ocean.foam_color, cam, -12.0, 0.0,
             spray_attrs=spray.advance(maps, scales, 1 / 30))
    torch.cuda.synchronize()
    before = LAUNCHES["tap"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        maps = ocean.update(1 / 30)
        attrs = spray.advance(maps, scales, 1 / 30)
        img = r.render(maps, scales, ocean.water_color, ocean.foam_color, cam, -12.0, 0.0,
                       spray_attrs=attrs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert LAUNCHES["tap"] - before == 1
    assert img.dtype == torch.uint8 and tuple(img.shape) == (72, 128, 3)


def test_web_viewer_serves_png_frames_from_the_card(card, monkeypatch):
    """The browser viewer on the card: 5 frames served over localhost,
    each a standard-library PNG of the viewer's size (forced, as on a machine
    without PIL), through K1 and K5."""
    import json
    import struct
    import urllib.request
    from godotoceanwaves_tpu_torch.utils import webviewer
    monkeypatch.setattr(webviewer, "jpeg_available", lambda: False)
    ocean = T.Ocean(map_size=256, map_dtype="bfloat16", updates_per_second=0, device=card)
    viewer = webviewer.WebViewer(ocean, fps=60.0, width=128, height=72, spray=True,
                                 spray_particles=1024)
    k1, k5 = LAUNCHES["fused_step"], LAUNCHES["tap"]
    port = viewer.start(port=0)
    try:
        get = lambda path: urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                                  timeout=60).read()
        bodies, deadline = [], time.time() + 120
        while len(bodies) < 5 and time.time() < deadline:
            frame = json.loads(get("/state"))["frame"]
            if frame >= 1 and (not bodies or frame > bodies[-1][0]):
                bodies.append((frame, get("/frame.png")))
            time.sleep(0.02)
    finally:
        viewer.stop()
    assert len(bodies) == 5
    for _, body in bodies:
        assert body[:8] == b"\x89PNG\r\n\x1a\n" and body[12:16] == b"IHDR"
        assert struct.unpack(">II", body[16:24]) == (128, 72)
    assert LAUNCHES["fused_step"] > k1 and LAUNCHES["tap"] > k5


# --- extreme parameters through K1, K4 and K2; the session's subset paths --

# tests/test_robustness.py's cases (this file imports no JAX), seed (3, -9)
EDGE_CASES = {
    "dead_calm": dict(wind_speed=1e-4, foam_amount=0.0),
    "hurricane": dict(wind_speed=80.0, fetch_length=2000.0, foam_amount=10.0),
    "zero_detail": dict(detail=0.0),
    "full_spread": dict(spread=1.0, swell=0.0),
    "max_swell": dict(swell=2.0, spread=0.0),
    "tiny_tile": dict(tile_length=(1.0, 1.0)),
    "huge_tile": dict(tile_length=(4096.0, 4096.0)),
    "anisotropic_tile": dict(tile_length=(16.0, 512.0)),
    "short_fetch": dict(fetch_length=1e-4),
    "zero_whitecap": dict(whitecap=0.0, foam_amount=10.0),
    "negative_wind_dir": dict(wind_direction=-360.0),
}
# (map size, config, the op whose kernels the card's step launches)
EDGE_PATHS = {
    "K1 bf16": (64, dict(map_dtype="bfloat16"), "fused_step"),
    "K1 f16": (64, dict(map_dtype="float16"), "fused_step"),
    "K4 2048 bf16": (2048, dict(map_dtype="bfloat16"), "strip_step"),
    "K2 fused=never": (64, dict(fused="never"), "planes_fft"),
}


@pytest.mark.parametrize("path", list(EDGE_PATHS))
@pytest.mark.parametrize("case", sorted(EDGE_CASES) + ["dt 1000 then -0.1"])
def test_extreme_params_through_the_kernels(card, case, path):
    """Each edge case of tests/test_robustness.py (3 steps of dt 0.1; the dt
    case: seed (1, 2), dt 1000 then -0.1) through the kernel on the card,
    against the same steps on the CPU (the plain versions) from the same
    state: finite maps, foam in [0, 1], within the kernel-vs-plain bounds."""
    n, cfg_kw, op = EDGE_PATHS[path]
    seed, dts = ((1, 2), (1000.0, -0.1)) if case.startswith("dt") else ((3, -9), (0.1,) * 3)
    p = T.models.stack_cascades([T.CascadeParams.create(spectrum_seed=seed, device="cpu",
                                                        **EDGE_CASES.get(case, {}))])
    cfg = T.SimConfig(map_size=n, **cfg_kw)
    cpu_state = T.init_state(cfg, p)
    state = cpu_state.replace(**{f: getattr(cpu_state, f).to(card)
                                 for f in ("h0", "h0nc", "omega", "foam", "time")})
    params = p.to(card)
    before = LAUNCHES[op]
    for dt in dts:
        state, maps = T.step(cfg, state, params, dt)
        cpu_state, cpu_maps = T.step(cfg, cpu_state, p, dt)
    torch.cuda.synchronize()
    assert LAUNCHES[op] - before == 2 * len(dts)
    d, nm = maps.displacement, maps.normal
    assert bool(d.isfinite().all()) and bool(nm.isfinite().all()), case
    assert 0.0 <= float(nm[:, 3].min()) and float(nm[:, 3].max()) <= 1.0, case
    assert_close((d, nm, state.foam), (cpu_maps.displacement, cpu_maps.normal, cpu_state.foam),
                 two_byte=cfg.map_dtype != "float32")


@pytest.mark.parametrize("stagger", [False, True])
def test_session_subset_paths_on_card_match_cpu(card, stagger):
    """A capped-rate session (skipped frames fold into dt; in stagger mode
    each frame refreshes one pending cascade through K1 on a one-cascade
    subset), a `set_cascade` that dirties cascade 1 (regenerated alone),
    then `set_cascades` to two cascades: the card against the CPU, update
    by update."""
    sessions = [T.Ocean(map_size=64, updates_per_second=30.0, stagger=stagger, device=d)
                for d in (card, "cpu")]
    before = LAUNCHES["fused_step"]
    for i, delta in enumerate([0.02, 0.05, 0.01, 0.04, 0.03, 0.02, 0.05, 0.01, 0.04]):
        for o in sessions:
            if i == 3:
                o.set_cascade(1, wind_speed=13.0, tile_length=41.0)
            if i == 6:
                o.set_cascades(T.default_cascades(device=o.device).map(lambda x: x[:2]))
            o.update(delta)
        gpu, cpu = sessions
        assert gpu._pending == cpu._pending and gpu.num_cascades == cpu.num_cascades
        assert_close((gpu.maps.displacement, gpu.maps.normal, gpu.state.foam),
                     (cpu.maps.displacement, cpu.maps.normal, cpu.state.foam), two_byte=False)
        assert torch.equal(gpu.state.time.cpu(), cpu.state.time)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_step"] > before


def test_mixed_size_session_on_card_matches_cpu(card):
    """BASELINE config 3 on the card: one `Ocean` over 1024^2, 256^2 and
    64^2 (bf16 maps), each size group on K1, against the same session on
    the CPU route, a group at a time, update by update. K1's launch tally
    reads a pair a group an update (6), and `ocean.step_group` 3 spans an
    update under `tracing()`: the first update's eager steps and every later
    update's graph replays alike."""
    from godotoceanwaves_tpu_torch.utils import observability
    sessions = [T.Ocean(map_size=(1024, 256, 64), map_dtype="bfloat16", updates_per_second=0,
                        device=d) for d in (card, "cpu")]
    gpu, cpu = sessions
    assert [c.step_tier() for c in gpu.config] == ["fused"] * 3
    updates = 4
    before = LAUNCHES["fused_step"]
    observability.reset()
    for _ in range(updates):
        with observability.tracing():
            gpu.update(0.02)
        cpu.update(0.02)
        for g, (n, idx) in enumerate(gpu.groups):
            got, want = gpu.maps[g], cpu.maps[g]
            assert got.displacement.shape == (len(idx), 3, n, n)
            assert torch.equal(gpu.state[g].time.cpu(), cpu.state[g].time)
            assert_close((got.displacement, got.normal, gpu.state[g].foam),
                         (want.displacement, want.normal, cpu.state[g].foam), two_byte=True)
    snap = observability.snapshot()
    assert LAUNCHES["fused_step"] - before == 6 * updates
    assert snap["counters"]["launches.fused_step"] == 6 * updates
    assert snap["counters"]["ocean.step_groups"] == 3 * updates
    assert snap["spans"]["ocean.step_group"]["count"] == 3 * updates


@pytest.mark.parametrize("sizes,options", [((1024, 256, 64), {}), ((64, 2048, 64), {}),
                                           ((128, 64, 128), {"fused": "never"})],
                         ids=["fused", "strip", "staged"])
def test_mixed_session_graphs_are_bit_equal_to_eager(card, sizes, options):
    """A mixed session on the card records each group's step at its first
    update and replays it after: every update's maps, foam and time equal,
    bit for bit, those of the same session under `graphs.disabled()`, at
    two dts, across a `set_cascade` (the edited group records anew, the
    others keep their recordings), two
    stagger updates (eager, then copied back in) and a checkpoint/restore.
    Maps handed out earlier stay as they were, and K1 counts a pair a group
    an update. Groups on the staged tier record no graph and stay eager."""
    sessions = [T.Ocean(map_size=sizes, map_dtype="bfloat16", updates_per_second=0,
                        device=card, **options) for _ in range(2)]
    graph, eager = sessions
    held, kept = [], []
    for k, dt in enumerate([0.02, 0.02, 1 / 60, 1 / 60, 0.02, 0.02, 0.02, 1 / 60, 0.02]):
        if k == 3:
            for o in sessions:
                o.set_cascade(len(sizes) - 1, wind_speed=21.0)
            recorded = list(graph._graphs)
        if k in (5, 6):
            for o in sessions:
                o.stagger = k == 5
        if k == 7:
            snap = graph.checkpoint()
            graph.update(0.02)
            graph.restore(snap)
            eager.restore(eager.checkpoint())
        before = LAUNCHES["fused_step"]
        maps = graph.update(dt)
        if not graph.stagger and all(c.step_tier() == "fused" for c in graph.config):
            assert LAUNCHES["fused_step"] - before == 2 * len(graph.groups)
        with graphs.disabled():
            want = eager.update(dt)
        for g in range(len(graph.groups)):
            for a, b in ((maps[g].displacement, want[g].displacement),
                         (maps[g].normal, want[g].normal),
                         (graph.state[g].foam, eager.state[g].foam),
                         (graph.state[g].time, eager.state[g].time)):
                assert torch.equal(a, b), (k, g)
        if k == 3:
            edited = [len(sizes) - 1 in idx and c.step_tier() != "staged"
                      for c, (_, idx) in zip(graph.config, graph.groups)]
            assert [r is not graph._graphs[g] for g, r in enumerate(recorded)] == edited
        held.append(maps)
        kept.append([(m.displacement.clone(), m.normal.clone()) for m in maps])
    assert [r is not None for r in graph._graphs] == [c.step_tier() != "staged"
                                                      for c in graph.config]
    assert all(r is None for r in eager._graphs)
    for maps, copies in zip(held, kept):
        for m, (d, n) in zip(maps, copies):
            assert torch.equal(m.displacement, d) and torch.equal(m.normal, n)


# --- the captured frame programs (utils/graphs.py) against graphs.disabled() --

def graph_scene(dev, n: int = 128):
    ocean = T.Ocean(map_size=n, map_dtype="bfloat16", updates_per_second=0, device=dev)
    maps = ocean.update(1 / 30)
    return ocean, maps, ocean.params.map_scales()


GRAPH_TIER = dict(mesh_quality="low", march_steps=32, bisect_steps=6, shade_res=2,
                  bracket_res=128, invert_res=256)


@pytest.mark.parametrize("case", ["render", "render_spray", "march_pallas"])
def test_graphed_render_is_bit_equal_to_eager(card, case):
    """A 160x96 frame replayed from its graph equals the eager frame
    (`graphs.disabled()`) bit for bit, at the first pose and at a second
    pose with other colours; the launches count per replay as eagerly; two
    frames the caller holds stay distinct."""
    ocean, maps, scales = graph_scene(card)
    kw = dict(GRAPH_TIER, march_impl="pallas") if case == "march_pallas" else GRAPH_TIER
    r = SceneRenderer(160, 96, **kw)
    attrs = None
    if case == "render_spray":
        spray = SpraySession(num_particles=2048, device=card)
        for _ in range(20):
            attrs = spray.advance(maps, scales, 0.25)
    poses = [(ocean.water_color, ocean.foam_color, (0.0, 12.0, 0.0), -12.0, 0.0, 70.0),
             ((0.3, 0.1, 0.05), (0.9, 0.9, 0.2), (3.0, 9.0, -4.0), -20.0, 35.0, 55.0)]
    frames = []
    for wc, fc, pos, pitch, yaw, fov in poses + poses:
        with graphs.disabled():
            counts = (LAUNCHES["tap"], LAUNCHES["march"], LAUNCHES["splat"], LAUNCHES["fan"])
            eager = r.render(maps, scales, wc, fc, pos, pitch, yaw, spray_attrs=attrs, fov=fov)
            torch.cuda.synchronize()
            eager_counts = (LAUNCHES["tap"] - counts[0], LAUNCHES["march"] - counts[1],
                            LAUNCHES["splat"] - counts[2], LAUNCHES["fan"] - counts[3])
        counts = (LAUNCHES["tap"], LAUNCHES["march"], LAUNCHES["splat"], LAUNCHES["fan"])
        img = r.render(maps, scales, wc, fc, pos, pitch, yaw, spray_attrs=attrs, fov=fov)
        torch.cuda.synchronize()
        assert (LAUNCHES["tap"] - counts[0], LAUNCHES["march"] - counts[1],
                LAUNCHES["splat"] - counts[2], LAUNCHES["fan"] - counts[3]) == eager_counts
        assert eager_counts == (1, 1 if case == "march_pallas" else 0,
                                1 if case == "render_spray" else 0,
                                0 if case == "march_pallas" else 1)
        assert torch.equal(img, eager)
        frames.append(img)
    assert r.programs[case.replace("march_pallas", "render")].num_graphs == 1
    assert not torch.equal(frames[0], frames[1])
    assert torch.equal(frames[0], frames[2]) and frames[0].data_ptr() != frames[2].data_ptr()


def test_graphed_spray_session_is_bit_equal_through_a_restore(card):
    """8 advances, a checkpoint restored into a fresh session, 8 more: the
    sessions' states and attrs with graphs on equal those inside
    `graphs.disabled()` bit for bit; either way an advance is one launch of
    the spray kernel, with no graph around it."""
    ocean, maps, scales = graph_scene(card)
    runs = {}
    for mode in ("graphed", "eager"):
        ctx = graphs.disabled() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            before = LAUNCHES["spray"]
            a = SpraySession(num_particles=4096, device=card)
            for _ in range(8):
                a.advance(maps, scales, 0.3)
            b = SpraySession(num_particles=16, device=card)
            b.restore(a.checkpoint())
            attrs = [b.advance(maps, scales, 0.3) for _ in range(8)]
            runs[mode] = (b.checkpoint()["state"], attrs)
            assert LAUNCHES["spray"] - before == 16
    (gs, ga), (es, ea) = runs["graphed"], runs["eager"]
    assert all(torch.equal(gs[k], es[k]) for k in es)
    assert all(torch.equal(g[k], e[k]) for g, e in zip(ga, ea) for k in e)


def test_graphed_batched_step_is_bit_equal_to_eager(card):
    """make_batched_step with K = 4 at 256^2 bf16, twice (the second call a
    replay): frames, state, spray state and the last maps equal the eager
    step's bit for bit; K1 2 a tick, K5, the splat chain and the spray
    kernel 1 a tick, as eagerly."""
    ocean = T.Ocean(map_size=256, map_dtype="bfloat16", updates_per_second=0, device=card)
    r = SceneRenderer(128, 72, **GRAPH_TIER)
    sp_params, sp_state = SpraySession(num_particles=2048, device=card).ensure_init()
    fn = make_batched_step(r, ocean.config, sp_params, 4)
    outs = {}
    for mode in ("graphed", "eager"):
        ctx = graphs.disabled() if mode == "eager" else contextlib.nullcontext()
        state, sps, clock, seq = ocean.state, sp_state, 0.0, []
        with ctx:
            for _ in range(2):
                before = (LAUNCHES["fused_step"], LAUNCHES["tap"], LAUNCHES["splat"],
                          LAUNCHES["spray"])
                state, sps, frames, last = fn(state, ocean.params, sps, clock, ocean.water_color,
                                              ocean.foam_color, (0.0, 12.0, 0.0), -12.0, 0.0,
                                              70.0, 1 / 30)
                torch.cuda.synchronize()
                made = tuple(LAUNCHES[op] - n for op, n in
                             zip(("fused_step", "tap", "splat", "spray"), before))
                assert made == (8, 4, 4, 4)
                clock += 4 / 30
                seq.append((frames, state, sps, last))
        outs[mode] = seq
    assert fn.program.num_graphs == 1
    for (gf, gst, gsp, gl), (ef, est, esp, el) in zip(outs["graphed"], outs["eager"]):
        assert torch.equal(gf, ef)
        assert torch.equal(gst.foam, est.foam) and torch.equal(gst.time, est.time)
        assert all(torch.equal(getattr(gsp, f), getattr(esp, f)) for f in
                   ("start_time", "cycle", "active", "base_scale"))
        assert torch.equal(gl.displacement, el.displacement) and torch.equal(gl.normal, el.normal)
    assert outs["graphed"][0][1].h0 is ocean.state.h0      # passed through, not copied


def test_batched_step_with_the_spray_kernel_stays_close_to_sequential_frames(card):
    """make_batched_step (K = 4) with the spray over 8 frames at 256^2 bf16,
    against the sequential loop (update, spray advance, render a frame) from
    one snapshot: frames within 1 uint8 step and >= 99.9 % of pixels equal
    (the K-frame clock accumulates in fp32 on the device); one spray kernel
    launch a tick."""
    k, total, dt = 4, 8, 1 / 30
    pose = ((0.0, 12.0, 0.0), -12.0, 0.0)
    sessions = []
    for _ in range(2):
        ocean = T.Ocean(map_size=256, map_dtype="bfloat16", updates_per_second=0, device=card)
        sessions.append((ocean, SpraySession(num_particles=4096, device=card)))
    (seq_o, seq_s), (bat_o, bat_s) = sessions
    for _ in range(12):
        seq_s.advance(seq_o.update(dt), seq_o.params.map_scales(), dt)
    bat_o.restore(seq_o.checkpoint())
    bat_s.restore(seq_s.checkpoint())
    r = SceneRenderer(128, 72, **GRAPH_TIER)
    seq = []
    for _ in range(total):
        maps = seq_o.update(dt)
        scales = seq_o.params.map_scales()
        seq.append(r.render(maps, scales, seq_o.water_color, seq_o.foam_color, *pose,
                            spray_attrs=seq_s.advance(maps, scales, dt)))
    sp_params, sp_state = bat_s.ensure_init()
    fn = make_batched_step(r, bat_o.config, sp_params, k)
    state, clock, bat = bat_o.state, bat_s.clock, []
    before = LAUNCHES["spray"]
    for _ in range(total // k):
        state, sp_state, frames, _ = fn(state, bat_o.params, sp_state, clock, bat_o.water_color,
                                        bat_o.foam_color, *pose, 70.0, dt)
        clock += k * dt
        bat.extend(frames)
    torch.cuda.synchronize()
    assert LAUNCHES["spray"] - before == total and fn.program.num_graphs == 1
    diff = (torch.stack(bat).short() - torch.stack(seq).short()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.999


def test_graphed_sample_field_is_bit_equal_to_eager(card):
    from godotoceanwaves_tpu_torch.utils import live
    _, maps, scales = graph_scene(card)
    with graphs.disabled():
        want = live._sample_field_graphed(maps, scales, 88.0, 96, 88)
    for _ in range(2):
        got = live._sample_field_graphed(maps, scales, 88.0, 96, 88)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_replayed_scene_frame_makes_no_host_sync(card):
    """An update, a spray advance and a render, each replayed from its
    graph, under torch.cuda.set_sync_debug_mode("error")."""
    ocean, maps, scales = graph_scene(card, 256)
    spray = SpraySession(num_particles=1024, device=card)
    r = SceneRenderer(128, 72, **GRAPH_TIER)
    for _ in range(2):                      # capture, then one replay
        maps = ocean.update(1 / 30)
        r.render(maps, scales, ocean.water_color, ocean.foam_color, (0.0, 12.0, 0.0), -12.0,
                 0.0, spray_attrs=spray.advance(maps, scales, 1 / 30))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        maps = ocean.update(1 / 30)
        img = r.render(maps, scales, ocean.water_color, ocean.foam_color, (1.0, 12.0, 0.0),
                       -12.0, 5.0, spray_attrs=spray.advance(maps, scales, 1 / 30))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert img.dtype == torch.uint8 and tuple(img.shape) == (72, 128, 3)


def test_a_capture_that_reads_the_host_raises(card):
    """A program that reads a value back to the host cannot be captured:
    the call raises (in a process of its own) instead of going on eagerly."""
    code = textwrap.dedent("""
        import torch
        from godotoceanwaves_tpu_torch.utils import graphs
        g = graphs.graphed(lambda x: x * float(x.sum()))
        x = torch.ones(4, device="cuda")
        try:
            g(x)
        except RuntimeError as e:
            print("raised:", str(e).splitlines()[0])
        else:
            raise SystemExit("the capture did not raise")
        assert g.num_graphs == 0
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(pathlib.Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0 and "raised:" in proc.stdout, proc.stderr[-3000:]
