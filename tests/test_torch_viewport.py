"""The port's scene renderer, frame pipeline, spray session and K-frame
step (models/viewport.py) vs the JAX package's, on the CPU; twins of
tests/test_viewport.py.

Maps come from the JAX package's `Ocean` (3 cascades at 64^2, cascade 0 at
wind 18 m/s, 8 updates) and cross over as NumPy arrays; frames are 128 x 72
on the "low" clipmap, the JAX side under its own jit. Tolerances:
`SceneRenderer` frames at the renderer's tolerance
(tests/test_torch_render.py:9-12: mean |delta| < 2e-3, here over the uint8
frame / 255); the YUV420 wire equal to the JAX package's within one uint8
step on <= 1 % of its bytes (a rounding tie can fall either way); K-frame
batched vs sequential frames at most 1 uint8 step apart with >= 99.9 % of
pixels equal (tests/test_viewport.py:246-249), foam and time within 1e-5,
displacement within 1e-4; a restored spray session bit-equal to the
unbroken one.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from godotoceanwaves_tpu import Ocean as JOcean
from godotoceanwaves_tpu.models import viewport as jviewport

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.models import viewport as tviewport
from godotoceanwaves_tpu_torch.models.viewport import (FramePipeline, RENDER_TIERS,
                                                       SceneRenderer, SpraySession,
                                                       make_batched_step, ycbcr_to_rgb,
                                                       yuv420_to_ycbcr)
from godotoceanwaves_tpu_torch.utils import convert

W, H = 128, 72
POSE = (np.array([0.0, 4.0, 0.0], np.float32), -10.0, 5.0)
RENDERERS = {
    "flat": dict(flat=True),
    "geometry": dict(),
    "geometry-mxu-interactive": dict(sampler="mxu", **RENDER_TIERS["interactive"]),
}


@pytest.fixture(scope="module")
def scene():
    o = JOcean(map_size=64, updates_per_second=0)
    o.set_cascade(0, wind_speed=18.0)
    maps = None
    for _ in range(8):
        maps = o.update(1 / 30) or maps
    scales = o.params.map_scales()
    tmaps = convert.maps_from_numpy(np.asarray(maps.displacement), np.asarray(maps.normal),
                                    device="cpu")
    return o, maps, scales, tmaps, torch.from_numpy(np.array(scales))


def spray_attrs(p=192, seed=4):
    """Billboard attributes of particles in view (most of them visible)."""
    rng = np.random.default_rng(seed)
    attrs = {
        "position": np.stack([rng.uniform(-15, 15, p), rng.uniform(0, 3, p),
                              rng.uniform(5, 40, p)], -1).astype(np.float32),
        "scale": rng.uniform(0.3, 2.0, (p, 3)).astype(np.float32),
        "dissolve": rng.uniform(0.2, 1, p).astype(np.float32),
        "custom_z": rng.uniform(0.3, 1, p).astype(np.float32),
        "visible": rng.uniform(0, 1, p) > 0.1,
    }
    return attrs, {k: torch.from_numpy(v) for k, v in attrs.items()}


@pytest.mark.parametrize("case,spray", [("flat", True), ("geometry", False),
                                        ("geometry-mxu-interactive", True)])
def test_scene_renderer_matches_jax(scene, case, spray):
    o, maps, scales, tmaps, tscales = scene
    jattrs, tattrs = spray_attrs() if spray else (None, None)
    kw = RENDERERS[case]
    want = np.asarray(jviewport.SceneRenderer(W, H, mesh_quality="low", **kw).render(
        maps, scales, o.water_color, o.foam_color, *POSE, spray_attrs=jattrs))
    got = SceneRenderer(W, H, mesh_quality="low", **kw).render(
        tmaps, tscales, o.water_color, o.foam_color, *POSE, spray_attrs=tattrs)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (H, W, 3)
    if spray:
        bare = SceneRenderer(W, H, mesh_quality="low", **kw).render(
            tmaps, tscales, o.water_color, o.foam_color, *POSE)
        assert (got != bare).any(), "the spray must show in the frame"
    diff = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.mean() / 255 < 2e-3, f"mean |delta| {diff.mean() / 255:.3e}"


@pytest.mark.parametrize("case,spray", [("flat", True), ("geometry-mxu-interactive", True),
                                        ("geometry", False)])
def test_scene_renderer_takes_pose_and_colours_as_tensors(scene, case, spray):
    """The pose and colours as tensors (the form a captured render takes
    them in on the card) give the frame the same numbers give, and so match
    the JAX package's at test_scene_renderer_matches_jax's bound; two
    frames the caller holds stay distinct."""
    o, maps, scales, tmaps, tscales = scene
    jattrs, tattrs = spray_attrs() if spray else (None, None)
    kw = RENDERERS[case]
    r = SceneRenderer(W, H, mesh_quality="low", **kw)
    numbers = r.render(tmaps, tscales, o.water_color, o.foam_color, *POSE, spray_attrs=tattrs)
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32))
    tensors = r.render(tmaps, tscales, f32(o.water_color), f32(o.foam_color),
                       *(f32(v) for v in POSE), spray_attrs=tattrs, fov=f32(70.0))
    assert torch.equal(tensors, numbers)
    want = np.asarray(jviewport.SceneRenderer(W, H, mesh_quality="low", **kw).render(
        maps, scales, o.water_color, o.foam_color, *POSE, spray_attrs=jattrs))
    diff = np.abs(tensors.numpy().astype(np.int16) - want.astype(np.int16))
    assert diff.mean() / 255 < 2e-3, f"mean |delta| {diff.mean() / 255:.3e}"
    moved = r.render(tmaps, tscales, o.water_color, o.foam_color, POSE[0] + 3.0, POSE[1],
                     POSE[2] + 20.0, spray_attrs=tattrs)
    assert (moved != numbers).any() and torch.equal(numbers, tensors)
    assert moved.data_ptr() != numbers.data_ptr()


def test_yuv420_wire_matches_jax_and_round_trips():
    """The device-side YUV420 wire: 1.5 B/px, equal to the JAX package's
    bytes but for rounding ties, and close to the direct RGB quantize on a
    smooth image (tests/test_viewport.py:34-70)."""
    h, w = 16, 24
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    srgb = np.stack([255 * xx / (w - 1), 255 * yy / (h - 1), np.full_like(xx, 90.0)], axis=-1)
    flat = tviewport._rgb_to_yuv420(torch.from_numpy(srgb)).numpy()
    want = np.asarray(jviewport._rgb_to_yuv420(jnp.asarray(srgb)))
    assert flat.dtype == np.uint8 and flat.shape == (h * w * 3 // 2,)
    d = np.abs(flat.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    direct = np.round(srgb).astype(np.uint8)
    rgb = ycbcr_to_rgb(yuv420_to_ycbcr(flat, h, w))
    assert np.max(np.abs(rgb.astype(int) - direct.astype(int))) <= 12
    assert np.mean(np.abs(rgb.astype(float) - direct.astype(float))) < 6.0
    y_direct = 0.299 * srgb[..., 0] + 0.587 * srgb[..., 1] + 0.114 * srgb[..., 2]
    assert np.max(np.abs(yuv420_to_ycbcr(flat, h, w)[..., 0] - y_direct)) <= 1.0
    # a flat colour survives exactly up to rounding, with no spatial artefacts
    const = torch.tensor([200.0, 64.0, 30.0]).expand(8, 12, 3)
    rgb = ycbcr_to_rgb(yuv420_to_ycbcr(tviewport._rgb_to_yuv420(const).numpy(), 8, 12))
    assert np.max(np.abs(rgb.astype(int) - [200, 64, 30])) <= 2 and (rgb == rgb[0, 0]).all()
    # the host unpack functions are the JAX package's
    np.testing.assert_array_equal(yuv420_to_ycbcr(flat, h, w),
                                  jviewport.yuv420_to_ycbcr(flat, h, w))


def test_scene_renderer_yuv420_transfer(scene):
    o, maps, scales, tmaps, tscales = scene
    r = SceneRenderer(64, 36, flat=True, transfer="yuv420")
    flat = r.render(tmaps, tscales, o.water_color, o.foam_color, *POSE)
    assert flat.dtype == torch.uint8 and tuple(flat.shape) == (64 * 36 * 3 // 2,)
    rgb = SceneRenderer(64, 36, flat=True).render(tmaps, tscales, o.water_color,
                                                  o.foam_color, *POSE).numpy()
    back = ycbcr_to_rgb(yuv420_to_ycbcr(flat.numpy(), 36, 64))
    assert np.abs(back.astype(int) - rgb.astype(int)).mean() < 6.0


def test_scene_renderer_rejects_bad_transfer_config():
    with pytest.raises(ValueError):
        SceneRenderer(64, 36, transfer="rgba")
    with pytest.raises(ValueError):
        SceneRenderer(63, 36, transfer="yuv420")


def test_render_tiers_are_valid_renderer_configs(scene):
    """Every tier builds a renderer and renders a uint8 frame of its shape;
    the tiers are the JAX package's."""
    assert RENDER_TIERS == jviewport.RENDER_TIERS
    o, maps, scales, tmaps, tscales = scene
    for kw in RENDER_TIERS.values():
        img = SceneRenderer(48, 28, mesh_quality="low", **kw).render(
            tmaps, tscales, np.zeros(3, np.float32), np.ones(3, np.float32),
            np.array([0.0, 9.0, 0.0], np.float32), -14.0, 0.0)
        assert tuple(img.shape) == (28, 48, 3) and img.dtype == torch.uint8


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_frame_pipeline_one_frame_lag_and_flush(kind):
    """push returns the PREVIOUS frame as host bytes (None first), flush
    drains the pending frame, every frame comes out once and in order, and
    each returned array is the caller's own."""
    p = FramePipeline()
    frames = [torch.full((2, 3, 3), i, dtype=torch.uint8) for i in range(4)]
    if kind == "numpy":
        frames = [f.numpy() for f in frames]
    out = [p.push(f) for f in frames]
    assert out[0] is None
    for i, got in enumerate(out[1:]):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, np.asarray(frames[i]))
    np.testing.assert_array_equal(p.flush(), np.asarray(frames[-1]))
    assert p.flush() is None
    assert p.push(frames[0]) is None
    assert FramePipeline().flush() is None


def test_frame_pipeline_discard():
    """discard() drops the pending frame without returning it."""
    p = FramePipeline()
    assert p.push(torch.zeros((2, 2, 3), dtype=torch.uint8)) is None
    p.discard()
    assert p.flush() is None
    assert p.push(torch.ones((2, 2, 3), dtype=torch.uint8)) is None
    out = p.flush()
    assert out is not None and out.max() == 1


def test_spray_session_checkpoint_resumes_cycles(scene):
    """A restored session continues the respawn cycles: B restores A's
    checkpoint and replays the same dts, bit-equal (tests/test_viewport.py:
    128-163)."""
    o, maps, scales, tmaps, tscales = scene
    a = SpraySession(num_particles=256, device="cpu")
    assert a.checkpoint() is None
    for _ in range(5):
        a.advance(tmaps, tscales, 0.4)
    snap = a.checkpoint()
    assert snap["clock"] == pytest.approx(2.0)
    assert snap["state"]["cycle"].dtype == torch.int32
    assert snap["state"]["active"].dtype == torch.bool
    a_attrs = [a.advance(tmaps, tscales, 0.4) for _ in range(3)]

    b = SpraySession(num_particles=8, device="cpu")    # restore overrides the ctor's
    b.restore(snap)
    assert b.started and b.clock == pytest.approx(2.0)
    b_attrs = [b.advance(tmaps, tscales, 0.4) for _ in range(3)]
    for aa, bb in zip(a_attrs, b_attrs):
        assert set(aa) == set(bb)
        for k in aa:
            assert torch.equal(aa[k], bb[k]), k
    for name in ("cycle", "active", "has_started", "start_time", "base_scale"):
        assert torch.equal(getattr(a._state, name), getattr(b._state, name)), name
    b.restore(None)
    assert not b.started and b.clock == 0.0


def _seq_frames(k, dt, pose, spray_on):
    ocean = T.Ocean(map_size=64, updates_per_second=0, device="cpu")
    r = SceneRenderer(64, 36, flat=True)
    session = SpraySession(num_particles=256, device="cpu") if spray_on else None
    frames = []
    for _ in range(k):
        maps = ocean.update(dt)
        scales = ocean.params.map_scales()
        attrs = session.advance(maps, scales, dt) if spray_on else None
        frames.append(r.render(maps, scales, ocean.water_color, ocean.foam_color, pose[0],
                               pose[1], pose[2], fov=pose[3], spray_attrs=attrs).numpy())
    return ocean, session, np.stack(frames)


@pytest.mark.parametrize("spray_on", [False, True])
def test_batched_step_matches_sequential_loop(spray_on):
    """K ticks through make_batched_step (one step_frames call, then a spray
    step and a render a tick) against K sequential update / advance /
    render ticks (tests/test_viewport.py:204-265)."""
    k, dt = 3, 1 / 30
    pose = (np.array([0.0, 10.0, 0.0], np.float32), -20.0, 15.0, 70.0)
    ocean_s, spray_s, seq = _seq_frames(k, dt, pose, spray_on)

    ocean = T.Ocean(map_size=64, updates_per_second=0, device="cpu")
    r = SceneRenderer(64, 36, flat=True)
    if spray_on:
        spray_params, spray_state = SpraySession(num_particles=256, device="cpu").ensure_init()
    else:
        spray_params, spray_state = None, None
    fn = make_batched_step(r, ocean.config, spray_params, k)
    state, spray_state, frames, last = fn(
        ocean.state, ocean.params, spray_state, np.float32(0.0), ocean.water_color,
        ocean.foam_color, pose[0], np.float32(pose[1]), np.float32(pose[2]),
        np.float32(pose[3]), np.float32(dt))
    frames = frames.numpy()
    assert frames.shape == (k, 36, 64, 3) and frames.dtype == np.uint8
    diff = np.abs(frames.astype(np.int16) - seq.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999
    np.testing.assert_allclose(state.foam.numpy(), ocean_s.state.foam.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.time.numpy(), ocean_s.state.time.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(last.displacement.numpy(), ocean_s.maps.displacement.numpy(),
                               rtol=0, atol=1e-4)
    if spray_on:
        np.testing.assert_allclose(spray_state.start_time.numpy(),
                                   spray_s._state.start_time.numpy(), rtol=0, atol=1e-5)
        assert torch.equal(spray_state.cycle, spray_s._state.cycle)
    else:
        assert spray_state is None


def test_spray_session_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SpraySession(num_particles=4)
