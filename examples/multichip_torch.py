"""Multi-card oceans on a mesh of processes (the PyTorch port of
examples/multichip.py).

Shards P independent ocean patches over the `patch` mesh axis and each
patch's 2D FFT over the `rows` axis (the FFT's transpose becomes an
exchange between positions: a copy inside a process, `all_to_all` between
processes). The (patch 2, rows 4) mesh's 8 positions are spread over the
worker processes: one NCCL worker per card by default, or K gloo workers on
the CPU:

    python examples/multichip_torch.py                      # the card(s)
    python examples/multichip_torch.py --cpu --processes 2  # 2 CPU workers
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

POSITIONS, ROWS, MAP_SIZE, STEPS = 8, 4, 256, 5


def worker() -> list[str]:
    """Every process: build the mesh, step it, render it; rank 0's lines."""
    from godotoceanwaves_tpu_torch import SimConfig, default_cascades
    from godotoceanwaves_tpu_torch.models.ocean import OceanMaps
    from godotoceanwaves_tpu_torch.parallel import (build_mesh, gather_maps, global_devices,
                                                    make_multichip_init, make_multichip_step,
                                                    multihost, multipatch_params,
                                                    render_geometry_sharded)
    dev = multihost.local_device()
    per = POSITIONS // multihost.process_count()
    # (patch=2, rows=4): two independent ocean patches, each FFT row-sharded
    # over 4 positions; the positions in process order, so a rows group may
    # span processes (make_multihost_mesh keeps it inside one)
    mesh = build_mesh(global_devices([dev] * per), rows=ROWS)
    lines = [f"mesh: {mesh.shape}"]
    config = SimConfig(map_size=MAP_SIZE)
    params = multipatch_params(default_cascades(device=dev), num_patches=2, seed=3)
    state = make_multichip_init(mesh, config)(params)
    step = make_multichip_step(mesh, config)
    for _ in range(STEPS):
        state, maps = step(state, params, 1 / 60)
    host = gather_maps(maps)                    # every process gets the global maps
    i, j, _ = next(mesh.local_positions())
    block = maps.blocks[i][j].displacement
    lines.append(f"displacement: {tuple(host.displacement.shape)} layout: blocks "
                 f"{tuple(block.shape)} over (patch, rows), process "
                 f"{multihost.process_index()} of {multihost.process_count()} holds positions "
                 f"{[(a, b) for a, b, _ in mesh.local_positions()]}")
    heights = host.displacement[:, :, 1].float()
    lines.append(f"per-patch height rms: {[round(float(h.std()), 3) for h in heights]}")
    # the frame's pixel rows spread over all 8 positions (each renders a band
    # of patch 0's ocean; the bands are all-gathered)
    patch0 = OceanMaps(displacement=host.displacement[0].to(dev), normal=host.normal[0].to(dev))
    img = render_geometry_sharded(
        mesh, patch0, params.map_scales()[0], width=320, height=176,
        camera_pos=(0.0, 6.0, 0.0), pitch_deg=-8.0, sampler="gather", gradient_lod=False,
        march_steps=16, bisect_steps=3)
    lines.append(f"sharded render: {tuple(img.shape)} row bands over {POSITIONS} positions, "
                 f"finite: {bool(img.isfinite().all())}")
    return lines


def main() -> None:
    from godotoceanwaves_tpu_torch.parallel import launch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo workers on the CPU")
    ap.add_argument("--processes", type=int, default=None,
                    help="worker processes (default: one per card; 1 with --cpu)")
    args = ap.parse_args()
    if args.cpu:
        procs = args.processes or 1
        devices = ["cpu"] * procs
    else:
        procs = args.processes or max(1, torch.cuda.device_count())
        devices = None                          # cuda:r for worker r; raises without cards
    for line in launch.run(worker, procs, devices=devices):
        print(line)


if __name__ == "__main__":
    main()
