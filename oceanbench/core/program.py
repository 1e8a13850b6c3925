"""The system under test, built from a configuration and a seed.

The only module of the benchmark that imports the program
(`godotoceanwaves_tpu_torch`), and only inside its functions, so that the
tests of the harness import it without the program's kernels, and so that
a test patches the program's module attributes in one place: every
function here, `entry` too, looks them up when it is called.

A driver reaches any public entry of the program through `entry`, by its
dotted path under the package (`entry("models.ocean.step_frames")`), with
the inputs built here from the configuration (`cascades`). A later cell
that drives another entry adds a driver file and names the entry there; no
file here needs an edit for it.
"""
from __future__ import annotations

import importlib

from . import spec

PACKAGE = "godotoceanwaves_tpu_torch"
CASCADE_FIELDS = ("displacement_scale", "normal_scale", "wind_speed", "wind_direction",
                  "fetch_length", "swell", "spread", "detail", "whitecap", "foam_amount")


def entry(name: str):
    """The program's public attribute at the dotted path `name` under its
    package: the module is everything before the last dot, imported now
    (`entry("models.ocean.step_frames")`, `entry("Ocean")`)."""
    parts = name.split(".")
    if not all(parts) or any(p.startswith("_") for p in parts):
        raise ValueError(f"{name!r} is not a dotted path of public names under {PACKAGE}")
    module = importlib.import_module(".".join([PACKAGE] + parts[:-1]))
    return getattr(module, parts[-1])


def cascades(config: dict, seed: int, device):
    """The configuration's cascades as one stacked `CascadeParams` on
    `device`, their spectrum seeds drawn from `seed` (`spec.cascade_specs`)."""
    from godotoceanwaves_tpu_torch.models.cascade import CascadeParams, stack_cascades
    return stack_cascades([
        CascadeParams.create(tile_length=tuple(c["tile_length"]),
                             spectrum_seed=tuple(c["spectrum_seed"]), device=device,
                             **{k: c[k] for k in CASCADE_FIELDS})
        for c in spec.cascade_specs(config, seed)])


def ocean(config: dict, seed: int, device):
    """`Ocean` with the configuration's cascades (`cascades`), stepping on
    every call (updates_per_second from the configuration)."""
    from godotoceanwaves_tpu_torch import Ocean
    return Ocean(params=cascades(config, seed, device), map_size=config["map_size"],
                 updates_per_second=config["updates_per_second"], device=device,
                 map_dtype=config["map_dtype"], depth=config["depth"], g=config["g"])


def spray_session(config: dict, device):
    from godotoceanwaves_tpu_torch.models.viewport import SpraySession
    return SpraySession(num_particles=config["spray"]["particles"],
                        emitter_extent=config["spray"]["emitter_extent"], device=device)


def renderer(config: dict, workload: dict):
    from godotoceanwaves_tpu_torch.models.viewport import RENDER_TIERS, SceneRenderer
    render = config["render"]
    tier = dict(RENDER_TIERS[render["tier"]])
    stated = {k: render[k] for k in tier}
    if stated != tier:
        raise ValueError(f"the configuration's render settings {stated} are not the "
                         f"program's {render['tier']!r} tier {tier}")
    return SceneRenderer(workload["width"], workload["height"],
                         mesh_quality=render["mesh_quality"],
                         environment=render["environment"], **tier)


def frame_pipeline():
    from godotoceanwaves_tpu_torch.models.viewport import FramePipeline
    return FramePipeline()


def map_streamer(step_fn, config: dict):
    """`MapStreamer` at the configuration's settings."""
    import numpy as np
    from godotoceanwaves_tpu_torch.utils.streaming import MapStreamer
    stream = config["stream"]
    return MapStreamer(step_fn, max_inflight=stream["max_inflight"],
                       host_dtype=np.dtype(stream["host_dtype"]).type)
