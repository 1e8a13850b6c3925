"""Entry points of the PyTorch port: one step of the flagship
pipeline, and the dry run of every multi-device path over several processes
(the counterpart of `__graft_entry__.py`). Imports `torch` and the port,
never JAX, here and in every worker it starts.

    python graft_entry_torch.py                      # entry(): one step on the card (K1)
    python graft_entry_torch.py --multichip          # dryrun_multichip(8) on the card(s)
    python graft_entry_torch.py --multichip --cpu    # 8 gloo workers on the CPU

The workers (`_dryrun_worker`, `sharded_frames`) live here, at the top
level of a module without JAX, because `parallel.launch.run` pickles them
by name and every worker imports this module.
"""
from __future__ import annotations

import functools
import sys

import torch

FOREIGN = ("jax", "jaxlib", "flax", "orbax", "godotoceanwaves_tpu")


def entry(device: torch.device | str = "cuda"):
    """(fn, args): one `step` of the reference demo scene's 3 cascades at
    512^2 (`__graft_entry__.entry`'s flagship): modulation, the packed 2D
    IFFT, map synthesis with persistent foam. On the card `fn(*args)` runs
    the fused-step kernel pair (K1); `device="cpu"` runs its plain version."""
    from godotoceanwaves_tpu_torch import SimConfig, default_cascades, init_state
    from godotoceanwaves_tpu_torch.models.ocean import step

    config = SimConfig(map_size=512)
    params = default_cascades(device=device)
    state = init_state(config, params)
    return functools.partial(step, config), (state, params, 1.0 / 60.0)


def foreign_modules() -> list[str]:
    """The modules of JAX or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN
                  and sys.modules[m] is not None)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _worker_mesh(layout: str, rows: int, per_process: int):
    """A mesh of every process's devices, `per_process` positions each:
    "multihost" keeps each rows group inside one process
    (`make_multihost_mesh`); "build" takes them in process order
    (`build_mesh`), so a rows group may span processes."""
    from godotoceanwaves_tpu_torch.parallel import multihost, sharding
    devices = multihost.global_devices([multihost.local_device()] * per_process)
    if layout == "multihost":
        return multihost.make_multihost_mesh(rows=rows, devices=devices)
    if layout == "build":
        return sharding.build_mesh(devices, rows=rows)
    raise ValueError(f"layout {layout!r}: expected 'multihost' or 'build'")


def sharded_frames(layout: str, rows: int, per_process: int, config: dict, params: dict,
                   state: dict | None = None, frames: int = 1, dt: float = 0.02,
                   save: str | None = None, restore: str | None = None) -> dict:
    """Worker: the sharded step on a mesh of every process (`_worker_mesh`).

    `config` holds `SimConfig` fields and `params` the (P, C) params as
    NumPy leaves. The state starts from `state` (global NumPy leaves), else
    from the checkpoint directory `restore`, else from the sharded init;
    after the first frame it is saved to `save` when given. Returns on
    rank 0: every frame's global maps and foam as NumPy ("frames": [(disp,
    normal, foam)], fp32), the mesh's owners ("owners"), every process's
    `gather_maps` of the last frame ("every_rank"), rank 0's launches of the
    rows kernel in the frames ("K3_launches") and the JAX modules loaded in
    the worker ("foreign").
    """
    from godotoceanwaves_tpu_torch import SimConfig
    from godotoceanwaves_tpu_torch.ops import rows_fft
    from godotoceanwaves_tpu_torch.parallel import multihost, sharding
    from godotoceanwaves_tpu_torch.utils import convert
    dev = multihost.local_device()
    mesh = _worker_mesh(layout, rows, per_process)
    cfg = SimConfig(**config)
    tp = convert.params_from_numpy(params, device=dev)
    if state is not None:
        st = sharding.shard_state(mesh, convert.state_from_numpy(state, device="cpu"))
    elif restore is not None:
        st = multihost.restore_sharded(restore, mesh)
    else:
        st = sharding.make_multichip_init(mesh, cfg)(tp)
    step = sharding.make_multichip_step(mesh, cfg)
    before = rows_fft.LAUNCHES
    out = []
    for k in range(frames):
        st, maps = step(st, tp, dt)
        if k == 0 and save is not None:
            multihost.save_sharded(save, st)
        host = multihost.gather_maps(maps)
        out.append((host.displacement.float().numpy(), host.normal.float().numpy(),
                    st.gather("cpu").foam.numpy()))
    every = [None] * multihost.process_count()
    torch.distributed.all_gather_object(every, out[-1][:2])
    return {"frames": out, "owners": mesh.processes.tolist(), "every_rank": every,
            "K3_launches": rows_fft.LAUNCHES - before, "foreign": foreign_modules()}


def _dryrun_worker(n_devices: int, device_type: str) -> dict:
    """Worker of `dryrun_multichip`: the three legs on a mesh of n_devices
    positions spread evenly over the processes, in process order."""
    from godotoceanwaves_tpu_torch import SimConfig, default_cascades
    from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
    from godotoceanwaves_tpu_torch.models.viewport import RENDER_TIERS
    from godotoceanwaves_tpu_torch.ops import rows_fft
    from godotoceanwaves_tpu_torch.parallel import multihost, sharding
    procs = multihost.process_count()
    dev = multihost.local_device()
    rows = 2 if n_devices % 2 == 0 else 1
    mesh = _worker_mesh("build", rows, n_devices // procs)
    patches = mesh.shape["patch"]
    out = {"mesh": mesh.shape, "processes": procs, "backend": torch.distributed.get_backend()}

    # leg 1: the sharded step (modulation -> the row-sharded 2D IFFT, its
    # exchange crossing processes where a rows group spans them -> maps + foam)
    config = SimConfig(map_size=64)
    params = sharding.multipatch_params(default_cascades(device=dev), patches, seed=0)
    state = sharding.make_multichip_init(mesh, config)(params)
    state, maps = sharding.make_multichip_step(mesh, config)(state, params, 0.02)
    host = multihost.gather_maps(maps)
    _check(tuple(host.displacement.shape) == (patches, 3, 3, 64, 64),
           f"leg 1: displacement {tuple(host.displacement.shape)}")
    _check(bool(host.displacement.isfinite().all()), "leg 1: non-finite sharded maps")

    # leg 2: the banded render of patch 0 over every position, at the
    # viewer's production settings (mxu sampler, gradient LOD, the
    # interactive tier, render_scale=2 with the catrom lift)
    patch0 = OceanMaps(displacement=host.displacement[0].to(dev),
                       normal=host.normal[0].to(dev))
    img = sharding.render_geometry_sharded(
        mesh, patch0, params.map_scales()[0], quality="low", width=64, height=16 * n_devices,
        camera_pos=(0.0, 6.0, 0.0), pitch_deg=-10.0, sampler="mxu", gradient_lod=True,
        render_scale=2, lift="catrom", **RENDER_TIERS["interactive"])
    _check(tuple(img.shape) == (16 * n_devices, 64, 3), f"leg 2: image {tuple(img.shape)}")
    _check(bool(img.isfinite().all()), "leg 2: non-finite sharded render")
    out["image"] = tuple(img.shape)

    # leg 3: the sharded FFT at N = 128 rows, 128 rows a position, against
    # a single-controller mesh: on the card the same step on CPU positions
    # (the rows kernel K3 against torch.fft), on the CPU the same positions
    # (the exchange across processes against copies: bit-equal)
    if rows > 1:
        n = 128 * rows
        cfg = SimConfig(map_size=n)
        params = sharding.multipatch_params(default_cascades(device=dev), patches, seed=1)
        before = rows_fft.LAUNCHES
        state = sharding.make_multichip_init(mesh, cfg)(params)
        _, maps = sharding.make_multichip_step(mesh, cfg)(state, params, 0.02)
        got = maps.gather("cpu").displacement
        out["K3_launches"] = rows_fft.LAUNCHES - before
        if multihost.process_index() == 0:
            ref_dev = torch.device("cpu")
            one = sharding.build_mesh([ref_dev] * n_devices, rows=rows)
            ref_params = params.map(lambda x: x.to(ref_dev))
            ref_state = sharding.make_multichip_init(one, cfg)(ref_params)
            _, ref = sharding.make_multichip_step(one, cfg)(ref_state, ref_params, 0.02)
            ref = ref.gather("cpu").displacement
            _check(bool(got.isfinite().all()), "leg 3: non-finite sharded FFT output")
            if device_type == "cuda":
                err = float((got.double() - ref.double()).pow(2).mean().sqrt()
                            / ref.double().pow(2).mean().sqrt().clamp_min(1e-12))
                _check(err < 1e-4, f"leg 3: rows kernel vs torch.fft rel RMS {err:.3e}")
                _check(out["K3_launches"] > 0, "leg 3: the rows kernel did not launch")
            else:
                err = float((got - ref).abs().max())
                _check(torch.equal(got, ref),
                       f"leg 3: the exchange across processes differs by {err:.3e}")
            out["leg3_err"] = err
            out["N"] = n
    out["foreign"] = foreign_modules()
    _check(not out["foreign"], f"the worker imported {out['foreign']}")
    return out


def dryrun_multichip(n_devices: int, *, processes: int | None = None,
                     device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run every multi-device path over n_devices mesh positions in several
    processes (`__graft_entry__.dryrun_multichip`'s three legs):

    1. the sharded step (patch, rows) with rows = 2 when n is even, else 1;
       finite maps (P, 3, 3, 64, 64);
    2. `render_geometry_sharded` of patch 0 at the interactive tier,
       render_scale=2, height 16 n, bands over every position;
    3. (rows > 1) the sharded FFT at N = 128 rows against the same step on
       a single-controller mesh: on the card the rows kernel (K3) against
       torch.fft on CPU positions (rel RMS < 1e-4), on the CPU the exchange
       across processes against copies (bit-equal).

    `device="cpu"` runs `processes` gloo workers (default: one a position);
    on the card, one NCCL worker per card present (or `processes`), the
    positions spread evenly over them. Raises when a leg fails; returns rank
    0's summary.
    """
    from godotoceanwaves_tpu_torch.models.cascade import require_device
    from godotoceanwaves_tpu_torch.parallel import launch
    device_type = require_device(device).type
    if device_type == "cpu":
        processes = processes or n_devices
        devices = ["cpu"] * processes
    else:
        processes = processes or torch.cuda.device_count()
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(processes)]
    if n_devices % processes:
        raise ValueError(f"{n_devices} positions do not spread evenly over {processes} "
                         "processes")
    out = launch.run(_dryrun_worker, processes, devices=devices, timeout_s=timeout_s,
                     args=(n_devices, device_type))
    rows = out["mesh"]["rows"]
    print(f"  leg 1/3 OK: sharded sim step (patch={out['mesh']['patch']}, rows={rows}, "
          f"{processes} {out['backend']} processes)")
    print(f"  leg 2/3 OK: sharded render ({out['image'][0]}x{out['image'][1]}, rows over "
          f"{n_devices} positions; mxu sampler, gradient LOD, interactive tier, "
          "render_scale=2 catrom lift)")
    if rows > 1:
        what = ("rows kernel (K3) vs torch.fft, rel RMS" if device_type == "cuda"
                else "exchange across processes vs copies, max abs")
        print(f"  leg 3/3 OK: sharded FFT at N={out['N']}, {rows}-way rows axis: {what} "
              f"{out['leg3_err']:.3e}")
    else:
        print(f"  leg 3/3 SKIPPED: the sharded FFT needs a >1 rows axis "
              f"(n_devices={n_devices} is odd)")
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--multichip" in args:
        cpu = "--cpu" in args
        procs = int(args[args.index("--processes") + 1]) if "--processes" in args else None
        dryrun_multichip(8, processes=procs, device="cpu" if cpu else "cuda")
        print("dryrun_multichip(8) OK")
    else:
        fn, fn_args = entry()
        state, maps = fn(*fn_args)
        torch.cuda.synchronize()
        print("entry() ran OK:", tuple(maps.displacement.shape),
              "finite:", bool(maps.displacement.isfinite().all()))
