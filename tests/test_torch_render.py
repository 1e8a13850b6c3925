"""The port's displaced-geometry renderer vs the JAX package's, on the CPU.

Maps come from the JAX package's `Ocean` (64^2, cascade 0 at wind 18 m/s,
8 updates: the scene of tests/test_geometry.py) and cross over as NumPy
arrays (`maps_from_numpy`), so both renderers shade identical inputs.
Frames are 128 x 72 on the "low" clipmap. The JAX side runs under
`jax.jit` (one compile per case instead of one per operation).

Tolerances: full frames agree to mean |delta| < 2e-3 with the sky masks
differing on < 0.5 % of pixels (a crossing can flip where the two packages'
fp32 rays differ by an ulp); the vertex stage to rtol/atol 1e-5
(tests/test_geometry.py:72); static tables bit-equal.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu import Ocean
from godotoceanwaves_tpu.models import camera as jcamera
from godotoceanwaves_tpu.models import geometry as jg
from godotoceanwaves_tpu.models import shading as js
from godotoceanwaves_tpu.utils import clipmap as jclip

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import camera as tcamera
from godotoceanwaves_tpu_torch.models import geometry as tg
from godotoceanwaves_tpu_torch.models import shading as ts
from godotoceanwaves_tpu_torch.utils import clipmap as tclip
from godotoceanwaves_tpu_torch.utils import convert

W, H = 128, 72
# low camera: crests top out above the 2.5 m eye line, so the horizon shows
# silhouettes (tests/test_geometry.py:17-19)
CAM = dict(camera_pos=(0.0, 2.5, 0.0), pitch_deg=-3.0, yaw_deg=0.0)
LIGHT = (0.3, 0.55, 0.9)
INTERACTIVE = dict(march_steps=32, bisect_steps=6, shade_res=2, bracket_res=128,
                   invert_res=256)

# the cases the port is held to, as render_ocean_geometry kwargs. The two
# "bench" cases are bench.py's render legs (interactive tier, environment
# on; the first runs the fan march and the LOD gradient taps), cut to size.
RENDER_CASES = {
    "gather-default": dict(march_steps=24, bisect_steps=6),
    "bench-mxu-lod-fan-env": dict(sampler="mxu", environment=True, **INTERACTIVE),
    "mxu-xla": dict(sampler="mxu", march_impl="xla", march_steps=24, bisect_steps=6),
    "bench-render-scale-2": dict(sampler="mxu", render_scale=2, environment=True,
                                 **INTERACTIVE),
    "rows-band": dict(sampler="mxu", rows=(24, 24), march_steps=24, bisect_steps=6),
}


@pytest.fixture(scope="module")
def scene():
    o = Ocean(map_size=64, updates_per_second=0)
    o.set_cascade(0, wind_speed=18.0)
    maps = None
    for _ in range(8):
        maps = o.update(1 / 30) or maps
    scales = o.params.map_scales()
    tmaps = convert.maps_from_numpy(np.asarray(maps.displacement, np.float32),
                                    np.asarray(maps.normal, np.float32),
                                    dtype=str(maps.displacement.dtype), device="cpu")
    return maps, scales, tmaps, torch.from_numpy(np.array(scales))


def _sky(pkg, kw):
    """The frame a renderer writes where every ray misses: its sky, the
    environment post when on, the render_scale lift when on."""
    s = kw.get("render_scale", 1)
    off, cnt = kw.get("rows") or (0, H)
    w, h, off, cnt = W // s, H // s, off // s, cnt // s
    if pkg == "jax":
        d = jg.camera_rays(w, h, CAM["pitch_deg"], CAM["yaw_deg"], 70.0,
                           row_offset=off, row_count=cnt)
        light = jnp.asarray(LIGHT, jnp.float32)
        light = light / jnp.linalg.norm(light)
        sky = js.sky_color(d, light)
        if kw.get("environment"):
            sky = js.apply_environment(sky, jnp.zeros(sky.shape[:2]),
                                       jnp.zeros(sky.shape[:2], bool))
        sky = jnp.clip(sky, 0.0, 1.0)
        if s > 1:
            lifted = jg._lift2d(sky, jnp.asarray(jg._scale_weights(cnt * s, cnt, "catrom")),
                                jnp.asarray(jg._scale_weights(W, w, "catrom")))
            near = lambda x: jnp.repeat(jnp.repeat(x, s, 0), s, 1)
            sky = jnp.clip(lifted, near(jg._pool3(sky, jnp.minimum)),
                           near(jg._pool3(sky, jnp.maximum)))
        return np.asarray(sky)
    d = tg.camera_rays(w, h, CAM["pitch_deg"], CAM["yaw_deg"], 70.0, row_offset=off,
                       row_count=cnt, device="cpu")
    light = torch.tensor(LIGHT)
    light = light / ts._norm(light)
    sky = ts.sky_color(d, light)
    if kw.get("environment"):
        sky = ts.apply_environment(sky, torch.zeros(sky.shape[:2]),
                                   torch.zeros(sky.shape[:2], dtype=torch.bool))
    sky = torch.clamp(sky, 0.0, 1.0)
    if s > 1:
        lifted = tg._lift2d(sky, torch.from_numpy(tg._scale_weights(cnt * s, cnt, "catrom")),
                            torch.from_numpy(tg._scale_weights(W, w, "catrom")))
        near = lambda x: x.repeat_interleave(s, 0).repeat_interleave(s, 1)
        sky = torch.minimum(torch.maximum(lifted, near(tg._pool3(sky, torch.minimum))),
                            near(tg._pool3(sky, torch.maximum)))
    return sky.numpy()


def _sky_mask(img, sky):
    return (np.abs(img - sky) < 1e-6).all(axis=-1)


def _render_pair(scene, kw):
    maps, scales, tmaps, tscales = scene
    full = dict(width=W, height=H, light_dir=LIGHT, **CAM, **kw)
    jfn = jax.jit(functools.partial(jg.render_ocean_geometry, quality="low", **full))
    want = np.asarray(jfn(maps, scales))
    got = tg.render_ocean_geometry(tmaps, tscales, "low", **full).numpy()
    return got, want


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_matches_jax(scene, case):
    kw = RENDER_CASES[case]
    got, want = _render_pair(scene, kw)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    mean = float(np.abs(got - want).mean())
    sky_t, sky_j = _sky_mask(got, _sky("torch", kw)), _sky_mask(want, _sky("jax", kw))
    assert sky_j.any() and (~sky_j).any(), "the frame must hold sky and water"
    mismatch = float((sky_t != sky_j).mean())
    assert mean < 2e-3, f"mean |delta| {mean:.3e}"
    assert mismatch < 5e-3, f"sky-mask mismatch {mismatch:.4f}"


@pytest.mark.parametrize("sampler", ["gather", "mxu"])
def test_displaced_grid_matches_jax(scene, sampler):
    maps, scales, tmaps, tscales = scene
    coords = jg.clipmap_axis_coords("low")
    cam, center = (3.0, 10.0, -2.0), (7.0, -5.0)
    want = jg.displaced_grid(maps, scales, jnp.asarray(coords), jnp.asarray(center),
                             jnp.asarray(cam), sampler=sampler)
    got = tg.displaced_grid(tmaps, tscales, torch.from_numpy(tg.clipmap_axis_coords("low").copy()),
                            torch.tensor(center), torch.tensor(cam), sampler=sampler)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quality", ["low", "high"])
def test_clipmap_axis_coords_bit_equal(quality):
    got, want = tg.clipmap_axis_coords(quality), jg.clipmap_axis_coords(quality)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tclip.build_clipmap_numpy(**tg.CLIPMAP_PRESETS[quality]),
                    jclip.build_clipmap_numpy(**jg.CLIPMAP_PRESETS[quality])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tclip.snap_to_tile((3.2, -7.9), 2.0),
                                  jclip.snap_to_tile((3.2, -7.9), 2.0))


@pytest.mark.parametrize("quality,res", [("low", 256), ("high", 512), ("high", 128)])
def test_static_tables_bit_equal(quality, res):
    for a, b in zip(tg._uniform_resample_tables(quality, res),
                    jg._uniform_resample_tables(quality, res)):
        np.testing.assert_array_equal(a, b)
    for n, stride in ((72, 2), (360, 2), (720, 3)):
        for a, b in zip(tg._upsample_weights(n, stride), jg._upsample_weights(n, stride)):
            np.testing.assert_array_equal(a, b)
    for kind in ("linear", "catrom"):
        np.testing.assert_array_equal(tg._scale_weights(W, W // 2, kind),
                                      jg._scale_weights(W, W // 2, kind))
    assert tg._pick_nbands(res // 2 + 8) == jg._pick_nbands(res // 2 + 8)


def test_fly_camera_is_a_copy():
    cams = jcamera.FlyCamera(), tcamera.FlyCamera()
    for cam in cams:
        cam.look(30.0, -12.0)
        cam.scroll(3)
        cam.move(0.5, forward=1.0, strafe=-0.5, rise=0.2, sprint=True)
        cam.look(-400.0, 900.0)
        cam.move(0.25, forward=-1.0)
    (jc, tc) = cams
    assert dataclasses.asdict(jc).keys() == dataclasses.asdict(tc).keys()
    np.testing.assert_array_equal(tc.position, jc.position)
    assert (tc.yaw, tc.pitch, tc.speed) == (jc.yaw, jc.pitch, jc.speed)
    for a, b in zip(tc.basis(), jc.basis()):
        np.testing.assert_array_equal(a, b)
    assert tc.render_kwargs() == jc.render_kwargs()


def test_map_scales_and_maps_from_numpy():
    jp = __import__("godotoceanwaves_tpu").default_cascades()
    np.testing.assert_array_equal(T.default_cascades(device="cpu").map_scales().numpy(),
                                  np.asarray(jp.map_scales()))
    rng = np.random.default_rng(3)
    disp = jnp.asarray(rng.normal(size=(2, 3, 8, 8)), jnp.bfloat16)
    normal = jnp.asarray(rng.normal(size=(2, 4, 8, 8)), jnp.bfloat16)
    maps = convert.maps_from_numpy(np.asarray(disp, np.float32), np.asarray(normal, np.float32),
                                   dtype="bfloat16", device="cpu")
    assert maps.displacement.dtype == torch.bfloat16 and maps.normal.shape == (2, 4, 8, 8)
    np.testing.assert_array_equal(maps.displacement.float().numpy(),
                                  np.asarray(disp, np.float32))
    kept = convert.maps_from_numpy(np.asarray(disp, np.float32), np.asarray(normal, np.float32),
                                   device="cpu")
    assert kept.displacement.dtype == torch.float32


@pytest.mark.parametrize("rows", [None, (16, 8)])
def test_camera_rays_match_jax(rows):
    off, cnt = rows or (0, None)
    want = jg.camera_rays(W, H, -7.0, 33.0, 65.0, row_offset=off, row_count=cnt)
    got = tg.camera_rays(W, H, -7.0, 33.0, 65.0, row_offset=off, row_count=cnt, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_debug_stage_prefix_consistency(scene):
    """The stages are prefixes of one render: shading the "grad" stage's
    gradient at the "march" stage's hits gives the full render there."""
    _, _, tmaps, tscales = scene
    kw = dict(width=64, height=32, shade_res=2, sampler="mxu", light_dir=LIGHT, **CAM)
    out = {st: tg.render_ocean_geometry(tmaps, tscales, "low", **kw, _debug_stage=st)
           for st in ("march", "uv", "grad", None)}
    assert out["march"].shape == (32, 64, 2) and out["uv"].shape == (32, 64, 2)
    assert out["grad"].shape == (32, 64, 3) and out[None].shape == (32, 64, 3)
    for st, v in out.items():
        assert bool(torch.isfinite(v).all()), st
    t_safe, hitf = out["march"].unbind(-1)
    assert set(hitf.unique().tolist()) <= {0.0, 1.0}
    hit = hitf > 0.5
    assert hit.any() and (~hit).any()
    d = tg.camera_rays(64, 32, CAM["pitch_deg"], CAM["yaw_deg"], 70.0, device="cpu")
    cam = torch.tensor(CAM["camera_pos"])
    p = cam + t_safe[..., None] * d
    light = torch.tensor(LIGHT)
    light = light / ts._norm(light)
    rgb = torch.clamp(ts.shade(out["grad"], p[..., 1], -d, light, t_safe), 0.0, 1.0)
    torch.testing.assert_close(rgb[hit], out[None][hit], rtol=0, atol=1e-6)
    # and the sky elsewhere
    sky = torch.clamp(ts.sky_color(d, light), 0.0, 1.0)
    torch.testing.assert_close(sky[~hit], out[None][~hit], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown _debug_stage"):
        tg.render_ocean_geometry(tmaps, tscales, "low", **kw, _debug_stage="bogus")
    with pytest.raises(ValueError, match="render_scale=1"):
        tg.render_ocean_geometry(tmaps, tscales, "low", width=64, height=32,
                                 render_scale=2, _debug_stage="uv")


def test_render_routing_arguments(scene):
    """tap_impl carries the JAX package's values over; the kernel routes
    raise where they cannot run; render_scale checks its divisibility."""
    _, _, tmaps, tscales = scene
    cpu = torch.device("cpu")
    assert tg._resolve_tap_impl("auto", cpu) == "einsum"
    assert tg._resolve_tap_impl("auto", torch.device("cuda", 0)) == "pallas"
    assert tg._resolve_tap_impl("pallas", torch.device("cuda", 0)) == "pallas"
    for impl in ("einsum", "pallas-interpret"):
        assert tg._resolve_tap_impl(impl, cpu) == "einsum"
    kw = dict(width=32, height=16, march_steps=4, bisect_steps=3)
    with pytest.raises(ValueError, match="CUDA"):
        tg.render_ocean_geometry(tmaps, tscales, "low", sampler="mxu", tap_impl="pallas", **kw)
    with pytest.raises(ValueError, match="unknown tap_impl"):
        tg._resolve_tap_impl("bogus", cpu)
    with pytest.raises(ValueError, match="uniform/mxu"):
        tg.render_ocean_geometry(tmaps, tscales, "low", march_impl="pallas", sampler="gather", **kw)
    with pytest.raises(ValueError, match="uniform-accel"):
        tg.render_ocean_geometry(tmaps, tscales, "low", march_impl="fan", accel="exact", **kw)
    with pytest.raises(ValueError, match="divisible"):
        tg.render_ocean_geometry(tmaps, tscales, "low", render_scale=3, **kw)
    # the einsum route renders the same frame under either name
    a = tg.render_ocean_geometry(tmaps, tscales, "low", sampler="mxu", tap_impl="einsum", **kw)
    b = tg.render_ocean_geometry(tmaps, tscales, "low", sampler="mxu",
                                 tap_impl="pallas-interpret", **kw)
    assert torch.equal(a, b)


def test_uniform_accel_matches_exact(scene):
    """accel="uniform" stays close to the exact graded-mesh march (the
    thresholds of tests/test_geometry.py's JAX pair)."""
    _, _, tmaps, tscales = scene
    kw = dict(width=W, height=H, light_dir=LIGHT, march_steps=28, bisect_steps=8, **CAM)
    uni = tg.render_ocean_geometry(tmaps, tscales, "low", accel="uniform", **kw).numpy()
    exact = tg.render_ocean_geometry(tmaps, tscales, "low", accel="exact", **kw).numpy()
    assert np.abs(uni - exact).mean() < 0.02
    sky = _sky("torch", {})
    assert (_sky_mask(uni, sky) != _sky_mask(exact, sky)).mean() < 0.02


@pytest.mark.parametrize("channels", [None, 3])
def test_mxu_table_sampler_matches_jax(channels):
    """`_mxu_sample` reads the two nonzero hat weights of the JAX package's
    dense rows: the same bf16 numbers, two-term fp32 sums."""
    rng = np.random.default_rng(7)
    g = 48
    table = rng.normal(0, 2.0, (g, g) if channels is None else (g, g, channels))
    table = table.astype(np.float32)
    center = np.asarray([3.0, -2.0], np.float32)
    qx = rng.uniform(-300, 300, (17, 9)).astype(np.float32)
    qz = rng.uniform(-300, 300, (17, 9)).astype(np.float32)
    origin, cell = -256.0, 512.0 / (g - 1)
    want = jg._mxu_sample(jnp.asarray(table), origin, cell, jnp.asarray(center),
                          jnp.asarray(qx), jnp.asarray(qz))
    got = tg._mxu_sample(torch.from_numpy(table), origin, cell, torch.from_numpy(center),
                         torch.from_numpy(qx), torch.from_numpy(qz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    f = torch.from_numpy(rng.uniform(0.0, g - 1.001, 300).astype(np.float32))
    dense = tg._hat_weights(f, g).float()
    np.testing.assert_array_equal(dense.numpy(), np.asarray(
        jg._hat_weights(jnp.asarray(f.numpy()), g).astype(jnp.float32)))
    i, w0, w1 = tg._hat_taps(f)
    sparse = torch.zeros_like(dense)
    sparse[torch.arange(300), i] += w0.to(torch.bfloat16).float()
    sparse[torch.arange(300), i + 1] += w1.to(torch.bfloat16).float()
    assert torch.equal(sparse, dense)


def test_surface_height_matches_jax(scene):
    maps, scales, tmaps, tscales = scene
    coords = jg.clipmap_axis_coords("low")
    cam, center = (3.0, 10.0, -2.0), (4.0, -2.0)
    grid = jg.displaced_grid(maps, scales, jnp.asarray(coords), jnp.asarray(center),
                             jnp.asarray(cam))
    tgrid = torch.from_numpy(np.array(grid))
    rng = np.random.default_rng(8)
    x, z = (rng.uniform(-200, 200, 64).astype(np.float32) for _ in range(2))
    jh, (jx, jz) = jg.surface_height(grid, jnp.asarray(coords), jnp.asarray(center),
                                     jnp.asarray(x), jnp.asarray(z), chop_iters=2)
    th, (tx, tz) = tg.surface_height(tgrid, torch.from_numpy(coords.copy()),
                                     torch.tensor(center), torch.from_numpy(x),
                                     torch.from_numpy(z), chop_iters=2)
    for a, b in ((th, jh), (tx, jx), (tz, jz)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
