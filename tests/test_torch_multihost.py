"""The port's multi-host layer (`parallel/multihost.py`) on a mesh of CPU
positions: the mesh's rows-on-one-host rule (the same ValueError as the JAX
package), checkpoint and restore onto another mesh layout, and
`gather_maps`. Tolerances as tests/test_multihost.py:43-63: foam <= 1e-5,
displacement <= 1e-4 (absolute).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu.parallel import multihost as jmh
from godotoceanwaves_tpu_torch.parallel import (build_mesh, gather_maps, make_multichip_init,
                                                make_multichip_step, make_multihost_mesh,
                                                multipatch_params, restore_sharded, save_sharded)

CPU = torch.device("cpu")
N = 64


def setup(mesh, num_patches, map_dtype="float32"):
    config = T.SimConfig(map_size=N, map_dtype=map_dtype)
    params = multipatch_params(T.default_cascades(device="cpu"), num_patches, seed=3)
    return config, params, make_multichip_init(mesh, config)(params), \
        make_multichip_step(mesh, config)


def test_multihost_mesh_keeps_rows_on_host():
    mesh = make_multihost_mesh(rows=2, devices=[CPU] * 8)
    assert mesh.shape == {"patch": 4, "rows": 2}
    assert make_multihost_mesh(devices=[CPU] * 8).shape == {"patch": 1, "rows": 8}
    with pytest.raises(ValueError, match="ICI"):
        jmh.make_multihost_mesh(rows=3)
    with pytest.raises(ValueError, match="one host"):
        make_multihost_mesh(rows=3, devices=[CPU] * 8)


def test_multihost_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_multihost_mesh(rows=1)


def test_sharded_checkpoint_roundtrip_and_reshard(tmp_path):
    mesh_a = build_mesh([CPU] * 8, rows=2)        # (4 patch, 2 rows)
    config, params, state, step = setup(mesh_a, num_patches=4)
    state, _ = step(state, params, 0.02)
    save_sharded(tmp_path / "ckpt", state)
    assert len(list((tmp_path / "ckpt").glob("shard_*.pt"))) == 8
    cont, maps_truth = step(state, params, 0.02)

    mesh_b = build_mesh([CPU] * 8, rows=4)        # (2 patch, 4 rows)
    restored = restore_sharded(tmp_path / "ckpt", mesh_b, state)
    assert len(restored.blocks) == 2 and restored.blocks[0][0].h0.shape == (2, 3, 2, N // 4, N)
    saved, back = state.gather(), restored.gather()
    for f in dataclasses.fields(saved):
        assert torch.equal(getattr(back, f.name), getattr(saved, f.name)), f.name
    cont_b, maps_b = make_multichip_step(mesh_b, config)(restored, params, 0.02)
    np.testing.assert_allclose(cont_b.gather().foam.numpy(), cont.gather().foam.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(maps_b.gather().displacement.numpy(),
                               maps_truth.gather().displacement.numpy(), atol=1e-4)


def test_restore_checks_the_template(tmp_path):
    mesh = build_mesh([CPU] * 8, rows=2)
    _, _, state, _ = setup(mesh, num_patches=4)
    save_sharded(tmp_path / "ckpt", state)
    _, _, other, _ = setup(mesh, num_patches=8)
    with pytest.raises(ValueError, match="template"):
        restore_sharded(tmp_path / "ckpt", mesh, other)
    with pytest.raises(ValueError, match="template"):
        restore_sharded(tmp_path / "ckpt", mesh, other.gather())
    mesh_b = build_mesh([CPU] * 8, rows=4)
    for template in (state, state.gather()):
        restored = restore_sharded(tmp_path / "ckpt", mesh_b, template)
        assert torch.equal(restored.gather().h0, state.gather().h0)


@pytest.mark.parametrize("map_dtype", ["float32", "bfloat16"])
def test_gather_maps_assembles_global_arrays(map_dtype):
    mesh = build_mesh([CPU] * 8, rows=2)
    _, params, state, step = setup(mesh, num_patches=4, map_dtype=map_dtype)
    _, maps = step(state, params, 0.02)
    host = gather_maps(maps)
    assert host.displacement.shape == (4, 3, 3, N, N)
    assert host.normal.shape == (4, 3, 4, N, N)
    assert host.displacement.device.type == "cpu"
    assert host.displacement.dtype == T.SimConfig(map_dtype=map_dtype).resolved_map_dtype()
    assert bool(host.displacement.isfinite().all())
    assert len(jax.devices()) == 8
