"""The port's multi-process form of `parallel/` on the CPU: gloo workers
started by `parallel.launch.run`, each holding its own mesh positions.

The workers run `graft_entry_torch.sharded_frames` (a worker imports the
module of its function, and this module imports JAX). The JAX package runs
here, on its 8 virtual CPU devices, from the same parameters and initial
state (NumPy leaves). Tolerances as tests/test_multihost.py:59-63: foam <=
1e-5, displacement <= 1e-4 (absolute); a rows group spanning processes is
bit-equal to the same mesh driven by one controller, since the exchange
only moves bytes. Every launch has a timeout of at most 120 s.
"""
import dataclasses
import functools
import json
import operator
import pathlib
import socket
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotoceanwaves_tpu as J
from godotoceanwaves_tpu.parallel import sharding as jsh
import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch.parallel import launch, multihost, sharding
from godotoceanwaves_tpu_torch.utils import convert

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import graft_entry_torch as G  # noqa: E402

CPU = torch.device("cpu")
N = 64
TIMEOUT = 120.0
TOL_DISP, TOL_FOAM = 1e-4, 1e-5


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def jax_frames(rows, patches, frames, dt=0.02):
    """(params, initial state) as NumPy leaves and `frames` frames of the
    JAX package's sharded step on a (patches, rows) mesh of its virtual
    devices, matmul FFT tier: [(displacement, normal, foam)]."""
    jp = jsh.multipatch_params(J.default_cascades(), num_patches=patches, seed=3)
    mesh = jsh.build_mesh(jax.devices()[:patches * rows], rows=rows)
    cfg = J.SimConfig(map_size=N, fft_impl="matmul")
    state = jsh.make_multichip_init(mesh, cfg)(jp)
    start = leaves(state)
    step = jsh.make_multichip_step(mesh, cfg)
    out = []
    for _ in range(frames):
        state, maps = step(state, jp, jnp.float32(dt))
        out.append(tuple(np.asarray(x, np.float32)
                         for x in (maps.displacement, maps.normal, state.foam)))
    return leaves(jp), start, out


def port_frames(mesh, params, state, frames, cfg=None, dt=0.02):
    """The same frames from one controller driving `mesh`."""
    cfg = cfg or T.SimConfig(map_size=N)
    tp = convert.params_from_numpy(params, device="cpu")
    st = convert.sharded_state_from_numpy(state, mesh)
    step = sharding.make_multichip_step(mesh, cfg)
    out = []
    for _ in range(frames):
        st, maps = step(st, tp, dt)
        g = maps.gather()
        out.append((g.displacement.float().numpy(), g.normal.float().numpy(),
                    st.gather().foam.numpy()))
    return out


def workers(nprocs, **kw):
    kw.setdefault("config", {"map_size": N})
    return launch.run(functools.partial(G.sharded_frames, **kw), nprocs,
                      devices=["cpu"] * nprocs, timeout_s=TIMEOUT)


def assert_near_jax(got, want):
    for (d, nm, foam), (wd, wn, wfoam) in zip(got, want, strict=True):
        np.testing.assert_allclose(d, wd, atol=TOL_DISP)
        np.testing.assert_allclose(nm, wn, atol=TOL_DISP)
        np.testing.assert_allclose(foam, wfoam, atol=TOL_FOAM)


def assert_equal_frames(got, want):
    for a, b in zip(got, want, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)


def test_rows_inside_processes_patch_across_matches_jax():
    """2 processes x 2 positions, `make_multihost_mesh(rows=2)`: (2, 2), each
    rows group inside one process, the patch axis across them; 3 frames."""
    params, state, want = jax_frames(rows=2, patches=2, frames=3)
    out = workers(2, layout="multihost", rows=2, per_process=2, params=params, state=state,
                  frames=3)
    assert out["owners"] == [[0, 0], [1, 1]]
    assert out["foreign"] == []
    assert_near_jax(out["frames"], want)
    assert_equal_frames(out["frames"], port_frames(sharding.build_mesh([CPU] * 4, rows=2),
                                                   params, state, 3))


@pytest.mark.parametrize("nprocs,per_process,owners", [(4, 1, [[0, 1, 2, 3]]),
                                                       (2, 2, [[0, 0, 1, 1]])])
def test_rows_across_processes_is_bit_equal(nprocs, per_process, owners):
    """One rows group of 4 positions spanning the processes, (1, 4): the
    exchange goes through all_to_all_single. Bit-equal to one controller,
    within tolerance of JAX; every process's gather_maps is the global
    value."""
    params, state, want = jax_frames(rows=4, patches=1, frames=3)
    out = workers(nprocs, layout="build", rows=4, per_process=per_process, params=params,
                  state=state, frames=3)
    assert out["owners"] == owners
    single = port_frames(sharding.build_mesh([CPU] * 4, rows=4), params, state, 3)
    assert_equal_frames(out["frames"], single)
    assert_near_jax(out["frames"], want)
    assert len(out["every_rank"]) == nprocs
    for disp, normal in out["every_rank"]:
        np.testing.assert_array_equal(disp, single[-1][0])
        np.testing.assert_array_equal(normal, single[-1][1])


def test_gather_maps_on_every_rank_equals_the_global_value():
    """2 processes on a (4, 1) mesh, bf16 maps (rows == 1: each position's
    `step`): every process's gather_maps equals the global maps of one
    controller, bit for bit."""
    jp = jsh.multipatch_params(J.default_cascades(), num_patches=4, seed=5)
    params = leaves(jp)
    tp = convert.params_from_numpy(params, device="cpu")
    cfg = T.SimConfig(map_size=N, map_dtype="bfloat16")
    state = convert.state_to_numpy(sharding.make_multichip_init(
        sharding.build_mesh([CPU] * 4, rows=1), cfg)(tp).gather())
    out = workers(2, layout="multihost", rows=1, per_process=2, params=params, state=state,
                  config={"map_size": N, "map_dtype": "bfloat16"})
    assert out["owners"] == [[0], [0], [1], [1]]
    single = port_frames(sharding.build_mesh([CPU] * 4, rows=1), params, state, 1, cfg)
    for disp, normal in out["every_rank"]:
        np.testing.assert_array_equal(disp, single[0][0])
        np.testing.assert_array_equal(normal, single[0][1])
    assert_equal_frames(out["frames"], single)


def test_checkpoint_saved_by_two_processes_restores_under_one_and_four(tmp_path):
    """Saved by 2 processes on (2, 2) after one frame; restored by one
    controller on (2, 4) and by 4 processes on (1, 4), rows across them;
    each continues one frame against the unbroken run. Each process wrote
    the files of its own positions only."""
    ckpt = tmp_path / "ckpt"
    params, state, _ = jax_frames(rows=2, patches=2, frames=0)
    out = workers(2, layout="multihost", rows=2, per_process=2, params=params, state=state,
                  frames=2, save=str(ckpt))
    truth = out["frames"][1]
    for writer, positions in enumerate(([(0, 0), (0, 1)], [(1, 0), (1, 1)])):
        index = json.loads((ckpt / f"index_{writer}.json").read_text())
        assert index["writers"] == 2
        assert [e["file"] for e in index["files"]] == [f"shard_{i}_{j}.pt" for i, j in positions]
    assert sorted(p.name for p in ckpt.glob("shard_*.pt")) == \
        [f"shard_{i}_{j}.pt" for i in range(2) for j in range(2)]

    mesh = sharding.build_mesh([CPU] * 8, rows=4)
    restored = multihost.restore_sharded(ckpt, mesh)
    cont, maps = sharding.make_multichip_step(mesh, T.SimConfig(map_size=N))(
        restored, convert.params_from_numpy(params, device="cpu"), 0.02)
    one = (maps.gather().displacement.numpy(), cont.gather().foam.numpy())
    four = workers(4, layout="build", rows=4, per_process=1, params=params, restore=str(ckpt))
    assert four["owners"] == [[0, 1, 2, 3]]
    for disp, foam in (one, (four["frames"][0][0], four["frames"][0][2])):
        np.testing.assert_allclose(foam, truth[2], atol=TOL_FOAM)
        np.testing.assert_allclose(disp, truth[0], atol=TOL_DISP)


def test_multihost_mesh_keeps_rows_inside_a_process():
    """2 processes x 4 positions, listed interleaved: rows=3 raises "one
    host"; rows 1, 2 and 4 keep each rows group inside one process and
    stride the patch axis over the processes. No process group here: the
    mesh is a layout, of which this process holds process 0's positions."""
    devices = [(p, CPU) for _ in range(4) for p in (0, 1)]
    with pytest.raises(ValueError, match="one host"):
        multihost.make_multihost_mesh(rows=3, devices=devices)
    with pytest.raises(ValueError, match="as many devices"):
        multihost.make_multihost_mesh(rows=1, devices=devices[:3])
    for rows in (1, 2, 4):
        mesh = multihost.make_multihost_mesh(rows=rows, devices=devices)
        assert mesh.shape == {"patch": 8 // rows, "rows": rows}
        assert all(len(set(group)) == 1 for group in mesh.processes.tolist())
        assert mesh.processes[:, 0].tolist() == sorted(mesh.processes[:, 0].tolist())
        assert [(i, j) for i, j, _ in mesh.local_positions()] == \
            [(i, j) for i in range(4 // rows) for j in range(rows)]
        assert all(mesh.rows_group(i) is None for i in range(8 // rows))
    across = sharding.build_mesh(devices, rows=2)
    assert across.processes.tolist() == [[0, 1]] * 4
    with pytest.raises(RuntimeError, match="process group"):
        across.rows_group(0)


def test_a_mesh_must_hold_every_process():
    """Under a process group of 2, a mesh whose positions are all process
    0's is refused in every worker, and `run` raises."""
    build = functools.partial(sharding.build_mesh, [(0, CPU), (0, CPU)], 2)
    with pytest.raises(RuntimeError, match="every process of the group"):
        launch.run(build, 2, devices=["cpu"] * 2, timeout_s=TIMEOUT)


def test_launcher_raises_for_a_failing_worker():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        launch.run(operator.truediv, 2, devices=["cpu"] * 2, timeout_s=TIMEOUT, args=(1, 0))


def test_launcher_raises_for_a_hung_worker():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 5.0 s"):
        launch.run(time.sleep, 2, devices=["cpu"] * 2, timeout_s=5.0, args=(60,))
    assert time.monotonic() - t0 < 30


def test_no_fallback_to_another_backend_or_device():
    with pytest.raises(ValueError, match="nccl"):
        multihost.initialize("file:///nonexistent", 1, 0, backend="nccl", local_device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.initialize("file:///nonexistent", 1, 0)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        multihost.initialize(local_device="cpu")
    assert not torch.distributed.is_initialized()


def test_initialize_from_torchrun_variables_and_shutdown(monkeypatch):
    """A world of one from MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE on
    localhost, then back to one controller after `shutdown`."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                     WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    multihost.initialize(local_device="cpu", timeout_s=TIMEOUT)
    try:
        assert (multihost.process_index(), multihost.process_count()) == (0, 1)
        assert multihost.global_devices() == [(0, CPU)]
        mesh = sharding.build_mesh(rows=1)
        assert mesh.collective and mesh.processes.tolist() == [[0]]
        assert not sharding.build_mesh([CPU] * 2).collective
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.local_device()
