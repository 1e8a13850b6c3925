"""The pieces of the `ocean4_1024.frames48` cell: the program's entries as the
harness reaches them, the configuration against the program's own scene, the
reference's clock against the port's plain route, and a call's roofline
counted by hand."""
import json

import numpy as np
import pytest
import torch

from oceanbench.core import manifest, program, roofline, spec
from oceanbench.core.frames_judge import held_frames
from oceanbench.reference.frames import RefFrames
from oceanbench.tests import tiny

CONFIG = json.loads((manifest.BENCH_DIR / "configs" / "ocean4_1024.json").read_text())
WORKLOAD = json.loads((manifest.BENCH_DIR / "workloads" / "ocean4_1024.frames48.json")
                      .read_text())


def test_entry_reaches_public_attributes_by_dotted_path(monkeypatch):
    import godotoceanwaves_tpu_torch
    from godotoceanwaves_tpu_torch.models import ocean
    assert program.entry("models.ocean.step_frames") is ocean.step_frames
    assert program.entry("Ocean") is godotoceanwaves_tpu_torch.Ocean
    patched = object()
    monkeypatch.setattr(ocean, "step_frames", patched)     # a test patches in one place
    assert program.entry("models.ocean.step_frames") is patched
    for bad in ("models.ocean._f32", "models._build.x", "models..step", ""):
        with pytest.raises(ValueError):
            program.entry(bad)
    with pytest.raises(AttributeError):
        program.entry("models.ocean.no_such_entry")


def _params_as_before_the_split(config, seed, device):
    """`program.ocean`'s params as it built them inline before `cascades`."""
    from godotoceanwaves_tpu_torch.models.cascade import CascadeParams, stack_cascades
    fields = ("displacement_scale", "normal_scale", "wind_speed", "wind_direction",
              "fetch_length", "swell", "spread", "detail", "whitecap", "foam_amount")
    return stack_cascades([
        CascadeParams.create(tile_length=tuple(c["tile_length"]),
                             spectrum_seed=tuple(c["spectrum_seed"]), device=device,
                             **{k: c[k] for k in fields})
        for c in spec.cascade_specs(config, seed)])


@pytest.mark.parametrize("name", ["scene_1024", "swell_2048"])
def test_ocean_builds_the_same_params_as_before_the_split(name, tmp_path):
    import dataclasses
    root = tiny.tiny_copy(tmp_path)
    config = json.loads((root / "oceanbench" / "configs" / f"{name}.json").read_text())
    got = program.ocean(config, tiny.SEED, "cpu").params
    want = _params_as_before_the_split(config, tiny.SEED, "cpu")
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name


def test_the_configuration_is_the_scene_and_its_first_cascade_again():
    from godotoceanwaves_tpu_torch.models.cascade import DEFAULT_SCENE
    scene = [dict(c, tile_length=list(c["tile_length"])) for c in DEFAULT_SCENE]
    assert CONFIG["cascades"][:3] == scene
    assert CONFIG["cascades"][3] == CONFIG["cascades"][0]
    assert (CONFIG["map_size"], CONFIG["map_dtype"], CONFIG["reduced"]) == (1024, "bfloat16", [])
    assert (WORKLOAD["frames"], WORKLOAD["dt"]) == (48, 0.02)


@pytest.mark.parametrize("first_call", [0, 1700])
def test_the_reference_clock_is_the_plain_routes_bit_for_bit(first_call, monkeypatch):
    """Every frame of three calls modulates at the reference's time, and the
    state's time after each call is the reference's start of the next, from
    the run's start and near the end of a 20 s window."""
    from godotoceanwaves_tpu_torch.models import ocean
    from godotoceanwaves_tpu_torch.models.cascade import SimConfig
    from godotoceanwaves_tpu_torch.ops import modulate
    config = dict(CONFIG, map_size=16)
    frames, dt = WORKLOAD["frames"], WORKLOAD["dt"]
    ref = RefFrames(config, spec.cascade_specs(config, tiny.SEED), dt, frames, "cpu")
    sim = SimConfig(map_size=16, map_dtype="bfloat16", depth=config["depth"], g=config["g"])
    params = program.cascades(config, tiny.SEED, "cpu")
    state = ocean.init_state(sim, params)
    assert np.array_equal(state.time.numpy(), ref.start(0))
    state = state.replace(time=torch.from_numpy(ref.start(first_call).copy()))
    seen = []
    real = modulate.modulate_planes
    monkeypatch.setattr(modulate, "modulate_planes",
                        lambda *a, **k: seen.append(a[4].clone()) or real(*a, **k))
    for call in range(first_call, first_call + 3):
        seen.clear()
        state, maps = ocean.step_frames(sim, state, params, dt, frames)
        assert maps.displacement.shape[:2] == (4, frames) and len(seen) == frames
        for k, t in enumerate(seen):
            assert np.array_equal(t.numpy().view(np.uint32),
                                  ref.time(call * frames + k).view(np.uint32)), (call, k)
        assert np.array_equal(state.time.numpy().view(np.uint32),
                              ref.start(call + 1).view(np.uint32)), call


@pytest.mark.parametrize("seed", [tiny.SEED, 7, 2 ** 40 + 11])
def test_the_judge_holds_every_frame_of_the_first_call_and_a_stride_of_the_others(seed):
    assert held_frames(seed, 0, 48, whole=True) == tuple(range(48))
    offsets = set()
    for tick in range(8, 2048, 97):
        got = held_frames(seed, tick, 48, whole=False)
        assert got == held_frames(seed, tick, 48, whole=False)      # from the seed
        assert got[0] == 0 and got[-1] == 47 and len(got) in (9, 10)
        stride = [k for k in got if k not in (0, 47)]
        assert 1 <= stride[0] <= 6 and all(b - a == 6 for a, b in zip(stride, stride[1:]))
        assert stride[-1] + 6 >= 47
        offsets.add(stride[0])
    assert len(offsets) > 1


def test_frames_roofline_counts_by_hand():
    # 4 x 1024^2, bf16, 48 frames: in 24 B a texel once, out 48 x 7 x 2 + 4 B; 8 scalars
    moved = roofline.frames_bytes(4, 1024, "bfloat16", 48)
    assert moved == 4 * (1024 * 1024 * (24 + 48 * 14 + 4) + 32) == 2936012928
    assert moved / 48 == pytest.approx(61.17e6, rel=1e-3)
    ms, by = roofline.frames_bound(4, 1024, "bfloat16", 48)
    flops_a_frame = 5 * 1024 * 10 * 4 * 8 * 1024
    assert flops_a_frame == pytest.approx(1.678e9, rel=1e-3)
    assert by == "operations" and ms == pytest.approx(flops_a_frame / 67e9)
    assert ms == pytest.approx(0.02504, abs=1e-5)
    # one frame is one step
    assert roofline.frames_bytes(3, 1024, "bfloat16", 1) == roofline.step_bytes(3, 1024,
                                                                                "bfloat16")
    assert roofline.frames_bound(2, 2048, "bfloat16", 1) == roofline.step_bound(2, 2048,
                                                                                "bfloat16")
