"""The comparison that decides `correct`: the timed path's outputs against the reference.

The drivers hold, for the window ticks that `spec.sample_ticks` draws from
the seed, what the timed path produced (the maps, the foam it carried, the
spray it advanced, the frame or host arrays it delivered) and the state it
started the tick from. Once the window has closed and the program's state
is freed, the reference (`oceanbench/reference`) recomputes each of them.

- The first `replay_ticks` window ticks are replayed from the run's first
  update with the reference's own foam: they check the start.
- Later ticks start from the foam the program carried into them (its own
  state, which the reference reads only there): a full replay of every
  update of a window would take longer than the window.
- The spray starts each sampled tick from the program's particle state,
  because its activation is a threshold on foam and a rounding-level
  difference can flip one particle; it reads the reference's maps.
- The frame is rendered by the frozen plain-route copy from the maps and
  the spray that the program's render was handed, each of them held to the
  reference by the numbers above: a billboard's scale follows foam near
  the spray's 0.9 threshold with a slope of 7.5, so one bf16 step of foam
  under a particle near the camera moves hundreds of pixels, and a frame
  rendered from the reference's own maps swings from seed to seed by that.

Numbers, each the worst over the sampled ticks:

- `maps_rms`: per cascade and map (displacement, normal), the RMS of the
  program's map less the reference's rounded to the map dtype, over the
  RMS of the reference's.
- `maps_max`: per cascade and map, the largest such difference over the
  reference's largest magnitude.
- `foam_rms`: the RMS of the carried fp32 foam less the reference's, over
  the RMS of the reference's, over all cascades.
- `spray_pos`: the largest distance in metres between a particle's
  position or scale and the reference's.
- `frame_mean`: the mean absolute difference of the delivered frame from
  the reference's render of the same maps and spray, in uint8 steps.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch


@dataclasses.dataclass
class Sample:
    tick: int                      # window tick
    update: int                    # the run's update index (warm-up included)
    foam_in: torch.Tensor | None   # (C, N, N) fp32 the update started from
    maps: tuple | None = None      # (displacement, normal) as produced or delivered
    foam_out: torch.Tensor | None = None
    spray_in: object = None        # the particle state the advance started from
    attrs: dict | None = None      # the advance's render attributes
    frame: np.ndarray | None = None    # the delivered uint8 frame
    pose: tuple | None = None      # (position, pitch, yaw, fov)


def _maps_numbers(got, ref, q) -> dict:
    """maps_rms and maps_max of one cascade's (displacement, normal)."""
    rms, mx = 0.0, 0.0
    for g, r in zip(got, ref):
        g = g.to(r.device, torch.float64)
        d = g - q(r)
        rms = max(rms, float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r).clamp_min(1e-300)))
        mx = max(mx, float(d.abs().max() / r.abs().max().clamp_min(1e-300)))
    return {"maps_rms": rms, "maps_max": mx}


class Judge:
    """Compares samples with the reference (or, `control=True`, puts the
    reference one precision lower in the program's place and compares
    that)."""

    def __init__(self, ref, control: bool = False):
        self.ref = ref
        self.control = control
        self._replay = {}

    def chain(self, wanted: frozenset, own: bool, start: tuple | None = None):
        """Yields (update, [(disp, normal, foam) per cascade]) for the `wanted`
        updates in order: the reference's (or the control's, `own=False`),
        stepping through every update up to the last of them, from zero foam
        at the run's first update or from `start`, (foam (C, N, N), update)."""
        step = self.ref.step if own else self.ref.control_step
        n, dev, cascades = self.ref.n, self.ref.device, range(self.ref.num_cascades)
        if start is None:
            foam = [torch.zeros((n, n), dtype=torch.float64, device=dev) for _ in cascades]
            first = 0
        else:
            foam = [start[0][c].to(dev, torch.float64) for c in cascades]
            first = start[1]
        for u in range(first, max(wanted) + 1):
            outs = [step(c, foam[c], u) for c in cascades]
            foam = [o[2] for o in outs]
            if u in wanted:
                yield u, outs

    def replay(self, wanted: frozenset, own: bool):
        """`chain` from zero foam, kept: {update: [(disp, normal, foam) per cascade]}."""
        key = (wanted, own)
        if key not in self._replay:
            self._replay[key] = dict(self.chain(wanted, own))
        return self._replay[key]

    def step_outputs(self, samples: list, replay_ticks: int):
        """Per sample: the reference's outputs by cascade, and what is judged
        (the program's, or the control's in its place)."""
        wanted = frozenset(s.update for s in samples if s.tick < replay_ticks)
        ref_chain = self.replay(wanted, own=True) if wanted else {}
        ctl_chain = self.replay(wanted, own=False) if wanted and self.control else {}
        for s in samples:
            refs, outs = [], []
            for c in range(self.ref.num_cascades):
                if s.tick < replay_ticks:
                    r = ref_chain[s.update][c]
                    o = ctl_chain[s.update][c] if self.control else None
                else:
                    foam_in = s.foam_in[c].to(self.ref.device, torch.float64)
                    r = self.ref.step(c, foam_in, s.update)
                    o = self.ref.control_step(c, foam_in, s.update) if self.control else None
                refs.append(r)
                outs.append(o)
            yield s, refs, outs

    def numbers(self, s: Sample, refs: list, outs: list) -> dict:
        """maps_rms, maps_max and foam_rms of one sample."""
        nums = {"maps_rms": 0.0, "maps_max": 0.0}
        foam_err = foam_ref = 0.0
        for c, r in enumerate(refs):
            if self.control:
                got, got_foam = outs[c][:2], outs[c][2]
            else:
                got = (s.maps[0][c], s.maps[1][c])
                got_foam = s.foam_out[c] if s.foam_out is not None else None
            for k, v in _maps_numbers(got, r[:2], self.ref.as_map_dtype).items():
                nums[k] = max(nums[k], v)
            if got_foam is not None:
                foam_err += float(torch.linalg.vector_norm(
                    got_foam.to(r[2].device, torch.float64) - r[2])) ** 2
                foam_ref += float(torch.linalg.vector_norm(r[2])) ** 2
        if foam_ref > 0.0 or foam_err > 0.0:
            nums["foam_rms"] = (foam_err ** 0.5) / max(foam_ref ** 0.5, 1e-300)
        return nums

    def maps(self, samples: list, replay_ticks: int) -> list:
        """[(tick, {maps_rms, maps_max, foam_rms})] for each sample."""
        return [(s.tick, self.numbers(s, refs, outs))
                for s, refs, outs in self.step_outputs(samples, replay_ticks)]


def render_frame(config: dict, workload: dict, pose, maps, attrs, scales,
                 lower: bool = False) -> torch.Tensor:
    """The frozen plain-route render of one frame with its spray, quantized
    as the program's renderer quantizes it: (H, W, 3) uint8. `lower` runs
    its products (the gradient taps, the splat) in bfloat16 under autocast,
    one precision below the fp32 it states: the control's render."""
    with torch.autocast(maps.displacement.device.type, dtype=torch.bfloat16, enabled=lower):
        return _render_frame(config, workload, pose, maps, attrs, scales)


def _render_frame(config, workload, pose, maps, attrs, scales) -> torch.Tensor:
    from oceanbench.reference.render import geometry, shading
    render = config["render"]
    kw = {k: render[k] for k in ("shade_res", "bracket_res", "invert_res")}
    wc = tuple(float(v) for v in np.asarray(config["water_color"], np.float32))
    fc = tuple(float(v) for v in np.asarray(config["foam_color"], np.float32))
    pos, pitch, yaw, fov = pose
    img = geometry.render_ocean_geometry(
        maps, scales, render["mesh_quality"], width=workload["width"],
        height=workload["height"], camera_pos=pos, pitch_deg=pitch, yaw_deg=yaw, fov_deg=fov,
        environment=render["environment"], march_steps=render["march_steps"],
        bisect_steps=render["bisect_steps"], tap_impl="einsum", water_color=wc,
        foam_color=fc, **kw)
    img = shading.splat_spray(img, attrs["position"], attrs["scale"], attrs["dissolve"],
                              attrs["visible"], camera_pos=pos, pitch_deg=pitch, yaw_deg=yaw,
                              fov_deg=fov, foam_color=fc, custom_z=attrs["custom_z"])
    return (torch.clamp(img, 0.0, 1.0) ** (1 / 2.2) * 255).to(torch.uint8)


def frame_numbers(judge: Judge, samples: list, replay_ticks: int, config: dict,
                  workload: dict) -> list:
    """[(tick, {maps_*, foam_rms, spray_pos, frame_mean})] for the
    frame driver's samples."""
    from oceanbench.reference.render import spray as ref_spray

    ref = judge.ref
    scales = ref.scales()
    params = ref_spray.SprayParams(num_particles=config["spray"]["particles"],
                                   emitter_extent=config["spray"]["emitter_extent"])
    dtype = ref.map_torch_dtype
    out = []
    for s, refs, outs in judge.step_outputs(samples, replay_ticks):
        nums = judge.numbers(s, refs, outs)
        # the maps reach the spray and the render in the map dtype, as the program's do
        ref_maps = types.SimpleNamespace(
            displacement=torch.stack([r[0] for r in refs]).to(dtype),
            normal=torch.stack([r[1] for r in refs]).to(dtype))
        if judge.control:
            maps = types.SimpleNamespace(
                displacement=torch.stack([o[0] for o in outs]).to(dtype),
                normal=torch.stack([o[1] for o in outs]).to(dtype))
        else:
            maps = ref_maps
        state = ref_spray.SprayState(**{f.name: getattr(s.spray_in, f.name).to(ref.device)
                                        for f in dataclasses.fields(ref_spray.SprayState)})
        clock = 0.0
        for _ in range(s.update + 1):     # the session's clock: one dt an advance
            clock += float(workload["dt"])
        _, want = ref_spray.spray_step(params, state, ref_maps, scales, clock)
        if judge.control:
            _, got = ref_spray.spray_step(params, state, maps, scales, clock)
        else:
            got = {k: v.to(ref.device) for k, v in s.attrs.items()}
        pos = max(float((got["position"] - want["position"]).abs().max()),
                  float((got["scale"] - want["scale"]).abs().max()))

        # the render is judged on its own inputs: the maps and spray it was
        # handed, each held to the reference above
        if judge.control:
            want_frame = render_frame(config, workload, s.pose, maps, got, scales)
            got_frame = render_frame(config, workload, s.pose, maps, got, scales, lower=True)
        else:
            program_maps = types.SimpleNamespace(displacement=s.maps[0], normal=s.maps[1])
            want_frame = render_frame(config, workload, s.pose, program_maps, got, scales)
            got_frame = torch.as_tensor(s.frame, device=ref.device)
        mean = float((got_frame.float() - want_frame.float()).abs().mean())
        out.append((s.tick, {**nums, "spray_pos": pos, "frame_mean": mean}))
    return out


def verdict(per_sample: list, limits: dict, expected: set) -> tuple[dict, int]:
    """({name: {"value", "limit"}} with the worst value over the samples,
    samples that failed). A sample that lacks a number, or a number that is
    not finite, fails."""
    worst = {name: 0.0 for name in limits}
    failed = 0
    for _, nums in per_sample:
        bad = False
        for name, limit in limits.items():
            v = nums.get(name)
            if v is None or not np.isfinite(v):
                worst[name] = float("inf")
                bad = True
                continue
            worst[name] = max(worst[name], v)
            bad |= v > limit
        failed += bad
    missing = expected - {t for t, _ in per_sample}
    if missing or not per_sample:
        failed += max(1, len(missing))
        worst = {name: float("inf") for name in limits}
    # a number that is not finite is written as null: the run is not correct
    return {name: {"value": worst[name] if np.isfinite(worst[name]) else None,
                   "limit": limits[name]} for name in limits}, failed
