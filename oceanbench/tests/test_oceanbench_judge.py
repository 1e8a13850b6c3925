"""`correct` comes out false when the timed path is broken underneath a run,
and when the control (the reference one precision lower) stands in the
program's place: each cell on the CPU at a tiny size, the card's look
skipped, the program patched where the fault would be produced.

The cells run on one card, so the fault of an exchange between cards has
no place here."""
import dataclasses

import numpy as np
import pytest
import torch

from oceanbench.tests import tiny

CELLS = tiny.workload_names()


@pytest.fixture
def root(tmp_path):
    return tiny.tiny_copy(tmp_path)


def _patch_step(monkeypatch, broken):
    """`broken` in place of the step (`Ocean.update`'s) and of a call of K
    frames (`step_frames`, whose maps carry a frame axis: (C, K, 3|4, N, N))."""
    from godotoceanwaves_tpu_torch.models import ocean
    real, real_frames = ocean.step, ocean.step_frames
    monkeypatch.setattr(ocean, "step", lambda config, state, params, dt: broken(
        real, config, state, params, dt))
    monkeypatch.setattr(ocean, "step_frames", lambda config, state, params, dt, k: broken(
        lambda *a: real_frames(*a, k), config, state, params, dt))


def state_unchanged(real, config, state, params, dt):
    _, maps = real(config, state, params, dt)
    return state, maps


def half_the_cascades(real, config, state, params, dt):
    new, maps = real(config, state, params, dt)
    half = state.foam.shape[0] // 2
    disp, normal, foam = maps.displacement.clone(), maps.normal.clone(), new.foam.clone()
    disp[half:] = 0
    normal[half:] = 0
    foam[half:] = state.foam[half:]
    return new.replace(foam=foam), dataclasses.replace(maps, displacement=disp, normal=normal)


def altered_map(real, config, state, params, dt):
    new, maps = real(config, state, params, dt)
    disp = maps.displacement.clone()
    disp[0, ..., 1, 0, :4] += 0.5     # four texels of one height row, half a metre up
    return new, dataclasses.replace(maps, displacement=disp)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_cascades, altered_map],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(cell, fault, root, monkeypatch):
    _patch_step(monkeypatch, fault)
    result = tiny.run(root, cell)
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def middle_frames_scaled(real, config, state, params, dt):
    new, maps = real(config, state, params, dt)
    disp, normal = maps.displacement.clone(), maps.normal.clone()
    disp[:, 1:-1] *= 1 + 1e-2
    normal[:, 1:-1] *= 1 + 1e-2
    return new, dataclasses.replace(maps, displacement=disp, normal=normal)


def final_foam_perturbed(real, config, state, params, dt):
    new, maps = real(config, state, params, dt)
    return new.replace(foam=new.foam + 1e-3), maps


def first_and_last_frames_swapped(real, config, state, params, dt):
    new, maps = real(config, state, params, dt)
    order = list(range(maps.displacement.shape[1]))
    order[0], order[-1] = order[-1], order[0]
    return new, dataclasses.replace(maps, displacement=maps.displacement[:, order],
                                    normal=maps.normal[:, order])


@pytest.mark.parametrize("fault", [middle_frames_scaled, final_foam_perturbed,
                                   first_and_last_frames_swapped], ids=lambda f: f.__name__)
def test_a_broken_call_of_frames_is_not_correct(fault, root, monkeypatch):
    _patch_step(monkeypatch, fault)
    result = tiny.run(root, "ocean4_1024.frames48")
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def one_middle_frame_scaled(real, config, state, params, dt):
    new, maps = real(config, state, params, dt)
    k = maps.displacement.shape[1] // 2 - 1          # frame 23 of 48; the foam left alone
    disp, normal = maps.displacement.clone(), maps.normal.clone()
    disp[:, k] *= 1 + 1e-2
    normal[:, k] *= 1 + 1e-2
    return new, dataclasses.replace(maps, displacement=disp, normal=normal)


@pytest.mark.parametrize("seed", [tiny.SEED, 7, 2 ** 40 + 11])
def test_one_broken_middle_frame_is_not_correct_on_every_seed(seed, root, monkeypatch):
    """The judge holds every frame of the first call, so a fault in one
    middle frame fails whatever frames the seed draws for the later calls."""
    _patch_step(monkeypatch, one_middle_frame_scaled)
    result = tiny.run(root, "ocean4_1024.frames48", seed=seed)
    assert not result["correct"] and result["failed"] > 0, result["checks"]


def test_an_altered_frame_is_not_correct(root, monkeypatch):
    from godotoceanwaves_tpu_torch.models import viewport
    real = viewport.SceneRenderer.render
    monkeypatch.setattr(viewport.SceneRenderer, "render",
                        lambda self, *a, **k: real(self, *a, **k).flip(-1))   # BGR for RGB
    result = tiny.run(root, "scene_1024.frame_720p")
    assert not result["correct"] and result["checks"]["frame_mean"]["value"] > \
        result["checks"]["frame_mean"]["limit"]


def test_altered_host_arrays_are_not_correct(root, monkeypatch):
    from godotoceanwaves_tpu_torch.utils import streaming
    real = streaming.MapStreamer._host

    def host(self, x):
        out = real(self, x)
        if out.shape[1] == 3:
            out[0, 1, 0, :4] += np.float32(0.5)
        return out
    monkeypatch.setattr(streaming.MapStreamer, "_host", host)
    result = tiny.run(root, "swell_2048.stream")
    assert not result["correct"], result["checks"]


def test_altered_spray_is_not_correct(root, monkeypatch):
    from godotoceanwaves_tpu_torch.models import spray
    real = spray.spray_step

    def step(params, state, maps, scales, now):
        new, attrs = real(params, state, maps, scales, now)
        return new, dict(attrs, position=attrs["position"] + torch.tensor([0.0, 0.5, 0.0]))
    monkeypatch.setattr(spray, "spray_step", step)
    from godotoceanwaves_tpu_torch.models import viewport
    monkeypatch.setattr(viewport, "_spray_step", viewport.graphs.graphed(step))
    result = tiny.run(root, "scene_1024.frame_720p")
    assert not result["correct"]
    assert result["checks"]["spray_pos"]["value"] > result["checks"]["spray_pos"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, root):
    result = tiny.run(root, cell, control=True)
    assert not result["correct"], result["checks"]
