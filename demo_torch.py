"""Demo app shell on the PyTorch port: the reference's main scene + panel, offline.

The counterpart of `demo.py`. Runs the default 3-cascade ocean (main.tscn
presets) through `godotoceanwaves_tpu_torch`, renders shaded frames of the
displaced geometry, optionally animates and composites the spray, and
prints the live parameter/metrics panel. Runs on the CUDA card; `--cpu`
runs everything on the CPU instead (the kernels' plain versions).

Examples:
  python demo_torch.py --frames 8 --out frames/            # PNG frame sequence
  python demo_torch.py --gif ocean.gif --frames 48 --spray  # animated GIF
  python demo_torch.py --cpu --map-size 64 --gif o.gif      # no card needed
  python demo_torch.py --map-size 512 --wind-speed 25 --panel
  python demo_torch.py --live                               # ANSI viewer:
      keys edit every cascade parameter at runtime (1-9 cascade, tab param,
      +/- adjust, C/c add/remove cascade, r resolution, u/U update rate, q)
  python demo_torch.py --web --port 8000 --spray            # browser viewer:
      open http://localhost:8000 (panel, fly camera, spray; frames as JPEG
      where PIL writes it, else as a standard-library PNG)
  python demo_torch.py --cpu --map-size 64 --web --width 128 --height 72

`--out` and `--gif` need PIL, which is imported only for them.
"""
from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--map-size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--warmup", type=int, default=30,
                    help="simulation updates before the first rendered frame")
    ap.add_argument("--wind-speed", type=float, default=None,
                    help="override cascade 0 wind speed (m/s)")
    ap.add_argument("--updates-per-second", type=float, default=0.0)
    ap.add_argument("--spray", action="store_true", help="simulate spray particles")
    ap.add_argument("--spray-particles", type=int, default=32768,
                    help="particle count (reference scale: 32768, main.tscn:137)")
    ap.add_argument("--out", type=str, default=None, help="PNG frame directory")
    ap.add_argument("--gif", type=str, default=None, help="animated GIF path")
    ap.add_argument("--panel", action="store_true", help="print the parameter panel")
    ap.add_argument("--live", action="store_true",
                    help="interactive terminal viewer with runtime editing")
    ap.add_argument("--web", action="store_true",
                    help="browser viewer with the reference's editing panel "
                         "(utils/webviewer.py)")
    ap.add_argument("--port", type=int, default=8000, help="--web HTTP port")
    ap.add_argument("--environment", action="store_true",
                    help="apply the reference scene's fog/tonemap post "
                         "(main.tscn:22-41) to rendered frames")
    ap.add_argument("--flat", action="store_true",
                    help="flat-plane render (no displaced geometry); the default "
                         "renders the vertex-displaced clipmap mesh "
                         "(water.gdshader:29-38)")
    ap.add_argument("--mesh-quality", choices=("low", "high"), default="high",
                    help="clipmap mesh grading (water.gd:43-46)")
    ap.add_argument("--render-tier", choices=("quality", "interactive", "performance"),
                    default=None,
                    help="render knob preset (models/viewport.RENDER_TIERS; "
                         "default: quality)")
    ap.add_argument("--render-scale", type=int, default=1,
                    help="dynamic resolution: march/shade at 1/s resolution and "
                         "upsample the finished frame on the device (width and "
                         "height must be divisible by s)")
    ap.add_argument("--camera", type=str, default="0,12,0",
                    help="camera position X,Y,Z")
    ap.add_argument("--pitch", type=float, default=-12.0,
                    help="camera pitch degrees (negative looks down)")
    ap.add_argument("--yaw", type=float, default=0.0, help="camera yaw degrees")
    ap.add_argument("--specular-aa", action="store_true",
                    help="screen-space specular anti-aliasing (not in the reference)")
    ap.add_argument("--frame-batch", type=int, default=1,
                    help="K-frame batching: step K frames at once "
                         "(models/viewport.make_batched_step), then render each; "
                         "needs --updates-per-second 0")
    ap.add_argument("--fov", type=float, default=70.0,
                    help="camera field of view, degrees (reference panel range "
                         "20-170, main.gd:113-114)")
    ap.add_argument("--ambience", type=str, default=None,
                    help="write the wind-mixed procedural ambience loop (WAV) for "
                         "the current cascade stack")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()

    if args.specular_aa and args.flat:
        ap.error("--specular-aa needs the geometry render path (no --flat)")
    if args.frame_batch < 1:
        ap.error("--frame-batch must be >= 1")
    if args.frame_batch > 1 and args.updates_per_second != 0:
        ap.error("--frame-batch > 1 steps every tick: use --updates-per-second 0")

    if args.ambience:
        # host-only: the mix law needs only the cascade wind speeds, read
        # from the scene's source of truth as plain NumPy (no device)
        import types

        from godotoceanwaves_tpu_torch.models.cascade import DEFAULT_SCENE
        from godotoceanwaves_tpu_torch.utils import audio
        ws = np.array([c["wind_speed"] for c in DEFAULT_SCENE], np.float32)
        if args.wind_speed is not None:
            ws[0] = args.wind_speed
        sr = 22050
        audio.write_wav(args.ambience, audio.render_ambience(
            types.SimpleNamespace(wind_speed=ws), sample_rate=sr), sr)
        print(f"ambience loop -> {args.ambience} "
              f"(gains db={audio.ambience_gains_db(float(ws.sum()))})")
        return

    import torch

    from godotoceanwaves_tpu_torch import Ocean
    from godotoceanwaves_tpu_torch.models.viewport import (RENDER_TIERS, FramePipeline,
                                                           SceneRenderer, SpraySession,
                                                           make_batched_step)
    from godotoceanwaves_tpu_torch.utils.observability import FrameStats, panel

    device = "cpu" if args.cpu else "cuda"
    ocean = Ocean(map_size=args.map_size, updates_per_second=args.updates_per_second,
                  device=device)
    if args.wind_speed is not None:
        ocean.set_cascade(0, wind_speed=args.wind_speed)

    if args.live:
        from godotoceanwaves_tpu_torch.utils.live import LiveViewer
        LiveViewer(ocean, fps=args.fps, mesh_quality=args.mesh_quality, spray=args.spray,
                   spray_particles=args.spray_particles).run()
        return

    if args.web:
        from godotoceanwaves_tpu_torch.utils.webviewer import WebViewer
        WebViewer(ocean, fps=min(args.fps, 30.0), width=args.width, height=args.height,
                  flat=args.flat, mesh_quality=args.mesh_quality, spray=args.spray,
                  spray_particles=args.spray_particles,
                  render_tier=args.render_tier or "interactive",
                  render_scale=args.render_scale, frame_batch=args.frame_batch,
                  specular_aa=args.specular_aa).run(port=args.port)
        return

    stats = FrameStats()
    dt = 1.0 / args.fps
    maps = None
    for _ in range(args.warmup):
        maps = ocean.update(dt) or maps

    tier_kw = dict(RENDER_TIERS[args.render_tier or "quality"])
    if args.render_scale > 1:
        tier_kw["render_scale"] = args.render_scale
    if args.specular_aa:
        tier_kw["specular_aa"] = True
    viewport = SceneRenderer(args.width, args.height, flat=args.flat,
                             mesh_quality=args.mesh_quality,
                             environment=args.environment, **tier_kw)
    spray_session = (SpraySession(num_particles=args.spray_particles, device=ocean.device)
                     if args.spray else None)
    cam_pos = tuple(float(v) for v in args.camera.split(","))
    # pipelined fetch: frame N's copy to the host overlaps frame N+1's work
    pipeline = FramePipeline()
    frames = []

    def collect(host):
        if host is not None:
            frames.append(host)

    if args.frame_batch > 1:
        spray_params, spray_state = (spray_session.ensure_init() if spray_session
                                     else (None, None))
        batched = make_batched_step(viewport, ocean.config, spray_params, args.frame_batch)
        clock, done = 0.0, 0
        while done < args.frames:
            t0 = time.perf_counter()
            ocean.state, spray_state, batch, ocean.maps = batched(
                ocean.state, ocean.params, spray_state, clock, ocean.water_color,
                ocean.foam_color, cam_pos, args.pitch, args.yaw, args.fov, dt)
            clock += dt * args.frame_batch
            for img in batch[:args.frames - done]:
                collect(pipeline.push(img))
            done += len(batch)
            stats.record((time.perf_counter() - t0) / args.frame_batch)
    else:
        scales = ocean.params.map_scales()
        for _ in range(args.frames):
            t0 = time.perf_counter()
            maps = ocean.update(dt) or maps
            attrs = (spray_session.advance(maps, scales, dt)
                     if spray_session is not None else None)
            img = viewport.render(maps, scales, ocean.water_color, ocean.foam_color, cam_pos,
                                  args.pitch, args.yaw, fov=args.fov, spray_attrs=attrs)
            collect(pipeline.push(img))
            stats.record(time.perf_counter() - t0)
    collect(pipeline.flush())
    if ocean.device.type == "cuda":
        torch.cuda.synchronize(ocean.device)

    if args.out:
        from PIL import Image
        outdir = pathlib.Path(args.out)
        outdir.mkdir(parents=True, exist_ok=True)
        for i, arr in enumerate(frames):
            Image.fromarray(arr).save(outdir / f"frame_{i:04d}.png")
        print(f"wrote {len(frames)} frames to {outdir}")
    if args.gif:
        from PIL import Image
        imgs = [Image.fromarray(a) for a in frames]
        imgs[0].save(args.gif, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / args.fps), loop=0)
        print(f"wrote {args.gif}")
    if args.panel or not (args.out or args.gif):
        print(panel(ocean, stats))
    if frames:
        print(f"frames: {len(frames)} x {frames[0].shape} {frames[0].dtype} on {ocean.device}")


if __name__ == "__main__":
    main()
