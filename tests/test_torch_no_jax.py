"""The PyTorch port steps and renders, unsharded and sharded, runs the scene
frame loop (spray, scene renderer, live viewer) and its graphed programs,
serves the browser viewer and runs its entry points, their spawned workers
and the benchmark, with JAX, flax and the JAX package unimportable."""
import pathlib
import subprocess
import sys
import textwrap


def test_port_imports_and_steps_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import godotoceanwaves_tpu_torch as T
        from godotoceanwaves_tpu_torch.models.ocean import multi_step
        ocean = T.Ocean(map_size=16, updates_per_second=0, device="cpu")
        maps = ocean.update(0.02)
        ocean.state, maps = multi_step(ocean.config, ocean.state, ocean.params, 0.02, 2)
        assert maps.displacement.shape == (3, 3, 16, 16)
        assert bool(maps.displacement.isfinite().all())
        from godotoceanwaves_tpu_torch.models import render_ocean_geometry
        img = render_ocean_geometry(maps, ocean.params.map_scales(), "low", width=32, height=16,
                                    sampler="mxu", march_steps=4, bisect_steps=3, shade_res=2)
        assert img.shape == (16, 32, 3) and bool(img.isfinite().all())
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_port_steps_and_renders_sharded_without_jax():
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "orbax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import torch
        import godotoceanwaves_tpu_torch as T
        from godotoceanwaves_tpu_torch import parallel
        mesh = parallel.build_mesh([torch.device("cpu")] * 4, rows=2)
        cfg = T.SimConfig(map_size=16)
        params = parallel.multipatch_params(T.default_cascades(device="cpu"), 2, seed=1)
        state = parallel.make_multichip_init(mesh, cfg)(params)
        state, maps = parallel.make_multichip_step(mesh, cfg)(state, params, 0.02)
        host = parallel.gather_maps(maps)
        assert host.displacement.shape == (2, 3, 3, 16, 16)
        assert bool(host.displacement.isfinite().all())
        one = T.OceanMaps(displacement=host.displacement[0], normal=host.normal[0])
        img = parallel.render_geometry_sharded(mesh, one, params.map_scales()[0], quality="low",
                                               width=32, height=16, sampler="mxu",
                                               march_steps=4, bisect_steps=3, shade_res=2)
        assert img.shape == (16, 32, 3) and bool(img.isfinite().all())
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_scene_frame_loop_without_jax():
    code = textwrap.dedent("""
        import io, sys
        for name in ("jax", "jaxlib", "flax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import godotoceanwaves_tpu_torch as T
        from godotoceanwaves_tpu_torch.models import SceneRenderer, SpraySession
        from godotoceanwaves_tpu_torch.utils import LiveViewer
        ocean = T.Ocean(map_size=16, updates_per_second=0, device="cpu")
        maps = ocean.update(0.02)
        scales = ocean.params.map_scales()
        spray = SpraySession(num_particles=64, device="cpu")
        attrs = spray.advance(maps, scales, 0.5)
        assert attrs["position"].shape == (64, 3)
        r = SceneRenderer(32, 16, mesh_quality="low", march_steps=4, bisect_steps=3)
        img = r.render(maps, scales, ocean.water_color, ocean.foam_color, (0.0, 8.0, 0.0),
                       -12.0, 0.0, spray_attrs=attrs)
        assert img.shape == (16, 32, 3) and str(img.dtype) == "torch.uint8"
        viewer = LiveViewer(ocean, cols=8, rows=4, input_fn=lambda: "", output=io.StringIO(),
                            spray=True, spray_particles=16)
        assert "\\x1b[38;2;" in viewer.frame()
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_web_viewer_serves_without_jax():
    code = textwrap.dedent("""
        import json, sys, time, urllib.request
        for name in ("jax", "jaxlib", "flax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import torch
        import godotoceanwaves_tpu_torch as T
        from godotoceanwaves_tpu_torch.utils.webviewer import WebViewer
        torch.set_num_threads(1)              # a viewer's threads beside busy cores
        ocean = T.Ocean(map_size=16, updates_per_second=0, device="cpu")
        viewer = WebViewer(ocean, fps=30.0, width=32, height=16, spray=True,
                           spray_particles=64)
        port = viewer.start(port=0)
        try:
            get = lambda path: urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=20)
            deadline = time.time() + 20
            state = json.loads(get("/state").read())
            while state["frame"] < 1 and time.time() < deadline:
                time.sleep(0.05)
                state = json.loads(get("/state").read())
            assert state["frame"] >= 1 and len(state["cascades"]) == 3
            r = get("/frame.png")
            body = r.read()
            assert r.headers["Content-Type"] in ("image/png", "image/jpeg") and len(body) > 50
        finally:
            viewer.stop()
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_graft_entry_and_its_spawned_workers_without_jax():
    """`graft_entry_torch` here and in 2 spawned gloo workers (whose dry run
    raises if its worker loaded JAX or the JAX package)."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "orbax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import graft_entry_torch
        fn, args = graft_entry_torch.entry(device="cpu")
        out = graft_entry_torch.dryrun_multichip(2, device="cpu", timeout_s=120)
        assert out["foreign"] == [] and out["processes"] == 2, out
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(pathlib.Path(__file__).resolve().parents[1]))


def test_bench_imports_and_runs_a_leg_without_jax():
    """`bench_torch.py` imports with JAX and the JAX package unimportable,
    and its config-4 and --rms legs run on the CPU."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import bench_torch
        r4 = bench_torch.bench_config4(device="cpu", map_size=16, k=2, frames=4, reps=2,
                                       baseline_k=2, baseline_reps=1)
        assert r4["min"] <= r4["p50"] <= r4["max"]
        assert bench_torch.bench_rms(device="cpu", map_size=16)["rms"] <= bench_torch.RMS_GATE
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=str(pathlib.Path(__file__).resolve().parents[1]))


def test_graphs_module_runs_the_frame_programs_without_jax():
    """`utils/graphs.py` and the graphed frame programs (the K-frame step,
    the ANSI field) import and run on CPU tensors with JAX unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "godotoceanwaves_tpu"):
            sys.modules[name] = None          # any import of these now fails
        import godotoceanwaves_tpu_torch as T
        from godotoceanwaves_tpu_torch.utils import graphs, live
        from godotoceanwaves_tpu_torch.models import SceneRenderer, SpraySession
        from godotoceanwaves_tpu_torch.models.viewport import make_batched_step
        ocean = T.Ocean(map_size=16, updates_per_second=0, device="cpu")
        maps = ocean.update(0.02)
        h, f = live._sample_field_graphed(maps, ocean.params.map_scales(), 40.0, 8, 4)
        assert tuple(h.shape) == (4, 8)
        sp, st = SpraySession(num_particles=32, device="cpu").ensure_init()
        fn = make_batched_step(SceneRenderer(16, 8, flat=True), ocean.config, sp, 2)
        with graphs.disabled():
            out = fn(ocean.state, ocean.params, st, 0.0, ocean.water_color, ocean.foam_color,
                     (0.0, 8.0, 0.0), -12.0, 0.0, 70.0, 0.02)
        assert tuple(out[2].shape) == (2, 8, 16, 3) and fn.program.num_graphs == 0
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                  and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
