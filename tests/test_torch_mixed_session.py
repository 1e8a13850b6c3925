"""A session whose cascades differ in map size (BASELINE config 3), on the CPU.

`Ocean(map_size=(64, 32, 16))` on the reference demo scene's three cascades
(config 3's 1024/256/64 cut to sizes a CPU test runs) against the
benchmark's plain reference of such a session
(`oceanbench/reference/mixed.py`, one `RefOcean` a size group on the
session's clock) and, a group at a time, against the JAX package's `Ocean`
at that group's size. Tolerances are the port's simulation bounds
(tests/test_torch_slice.py, tests/test_torch_session.py): maps <= 1e-4
relative RMS, foam <= 1e-4 RMS. A session of one size is pinned to the
one-size path: one `step` an update, bare `SimConfig`, `OceanState` and
`OceanMaps`.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import godotoceanwaves_tpu as J
import godotoceanwaves_tpu_torch as T
from godotoceanwaves_tpu_torch import parallel
from godotoceanwaves_tpu_torch.models import ocean as tocean
from godotoceanwaves_tpu_torch.models.viewport import (SceneRenderer, SpraySession,
                                                       make_batched_step)
from godotoceanwaves_tpu_torch.utils import convert, observability
from godotoceanwaves_tpu_torch.utils.live import LiveViewer
from godotoceanwaves_tpu_torch.utils.streaming import MapStreamer, preview_maps
from godotoceanwaves_tpu_torch.utils.webviewer import WebViewer
from oceanbench.reference.mixed import RefMixed

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = (64, 32, 16)
DT = 0.02


def leaves(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(1e-12, np.sqrt(np.mean(ref ** 2))))


def rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2)))


def assert_maps_close(disp, normal, foam, want_disp, want_normal, want_foam):
    assert rel_rms(disp, want_disp) <= 1e-4
    assert rel_rms(normal, want_normal) <= 1e-4
    assert rms(foam, want_foam) <= 1e-4


def scene_params():
    """The scene's three cascades in both packages, the JAX package's seeds."""
    jp = J.default_cascades()
    return jp, convert.params_from_numpy(leaves(jp), device="cpu")


def mixed(sizes=SIZES, **kw):
    jp, tp = scene_params()
    return jp, T.Ocean(params=tp, map_size=sizes, updates_per_second=0, device="cpu", **kw)


def jax_groups(jp, session):
    """A JAX `Ocean` a size group of `session`, on its cascades, at its
    size, each cascade's time set to the port group's (the session's
    clock: 120 + pi i by the index in the session)."""
    out = []
    for (n, idx), state in zip(session.groups, session.state):
        params = jax.tree_util.tree_map(lambda x: x[np.asarray(idx)], jp)
        jo = J.Ocean(params=params, map_size=n, updates_per_second=0)
        jo.state = jo.state.replace(time=jnp.asarray(state.time.numpy()))
        out.append(jo)
    return out


def assert_groups_match_jax(session, jaxes):
    for g, jo in enumerate(jaxes):
        assert_maps_close(session.maps[g].displacement.numpy(), session.maps[g].normal.numpy(),
                          session.state[g].foam.numpy(), jo.maps.displacement, jo.maps.normal,
                          jo.state.foam)


def test_groups_follow_first_appearance_and_the_session_clock():
    _, o = mixed((16, 32, 16))
    assert o.groups == ((16, (0, 2)), (32, (1,)))
    assert o.map_sizes == (16, 32, 16)
    assert [c.map_size for c in o.config] == [16, 32]
    assert [c.step_tier() for c in o.config] == ["fused", "fused"]
    # cascade i starts at 120 + pi i by its index in the session, as a one-size session's
    whole = T.init_state(T.SimConfig(map_size=16), o.params).time
    torch.testing.assert_close(o.state[0].time, whole[[0, 2]], rtol=0, atol=0)
    torch.testing.assert_close(o.state[1].time, whole[[1]], rtol=0, atol=0)
    assert [m.displacement.shape for m in o.maps] == [(2, 3, 16, 16), (1, 3, 32, 32)]
    with pytest.raises(ValueError, match="2 sizes for 3 cascades"):
        mixed((16, 32))
    with pytest.raises(ValueError, match="power of two"):
        mixed((16, 48, 16))


def test_mixed_session_matches_the_reference_group_by_group():
    """Six updates with the foam carried, each group against its `RefGroup`
    chained from zero foam, update by update."""
    jp, o = mixed()
    config = json.loads((ROOT / "oceanbench/configs/mixed_1024_256_64.json").read_text())
    config.update(map_sizes=list(SIZES), map_dtype="float32")
    seeds = o.params.spectrum_seed.tolist()
    specs = [dict(c, spectrum_seed=s) for c, s in zip(config["cascades"], seeds)]
    ref = RefMixed(config, specs, DT, "cpu")
    assert [(g.n, g.indices) for g in ref.groups] == [(n, idx) for n, idx in o.groups]
    foam = [[torch.zeros((g.n, g.n), dtype=torch.float64)] * g.num_cascades for g in ref.groups]
    for u in range(6):
        maps = o.update(DT)
        assert isinstance(maps, tuple) and len(maps) == 3
        for g, group in enumerate(ref.groups):
            for c in range(group.num_cascades):
                disp, normal, foam[g][c] = group.step(c, foam[g][c], u)
                assert_maps_close(maps[g].displacement[c], maps[g].normal[c],
                                  o.state[g].foam[c], disp, normal, foam[g][c])


def test_mixed_session_matches_the_jax_package_a_group_at_a_time():
    jp, o = mixed()
    jaxes = jax_groups(jp, o)
    for dt in (DT, 0.03, DT, 0.01):
        o.update(dt)
        for jo in jaxes:
            jo.update(dt)
        assert_groups_match_jax(o, jaxes)


def test_set_cascade_regenerates_the_small_cascade_in_its_group():
    """A spectrum edit of cascade 2 (16^2) dirties it alone; the next update
    regenerates it in its group and keeps parity with the JAX session of
    that group given the same edit."""
    jp, o = mixed()
    jaxes = jax_groups(jp, o)
    o.update(DT)
    for jo in jaxes:
        jo.update(DT)
    big_h0 = o.state[0].h0
    o.set_cascade(2, wind_speed=13.0, tile_length=11.0)
    jaxes[2].set_cascade(0, wind_speed=13.0, tile_length=11.0)
    assert o._dirty.tolist() == [False, False, True]
    with observability.tracing():
        observability.reset()
        o.update(DT)
        snap = observability.snapshot()
    for jo in jaxes:
        jo.update(DT)
    assert snap["counters"]["ocean.regenerated"] == 1
    assert o.state[0].h0 is big_h0                  # other groups keep their spectra
    assert_groups_match_jax(o, jaxes)


def test_set_cascade_cuts_only_its_groups_params_and_the_cpu_records_no_graph():
    """`set_cascade(i)` cuts the params slice of cascade i's group anew and
    keeps the other groups' slices, the very objects, so that a group's
    recorded step on the card still fits them; off the card no group
    records a graph."""
    o = T.Ocean(params=scene_params()[1], map_size=(64, 32, 64), updates_per_second=0,
                device="cpu")
    o.update(DT)
    before = o._group_params
    o.set_cascade(1, whitecap=0.4)
    assert o._group_params[0] is before[0]
    assert o._group_params[1] is not before[1]
    assert o._group_params[1].whitecap.tolist() == pytest.approx([0.4])
    o.update(DT)
    assert o._graphs == [None, None]


def test_stagger_refreshes_one_cascade_a_frame_in_session_order():
    """At 20 updates a second and 60 frames, each round refreshes cascade 0
    with the update and cascades 1 and 2 on the next two frames, each in
    its group; at a round's end every group equals the unstaggered
    session's."""
    _, staggered = mixed(stagger=True)
    _, plain = mixed()
    for o in (staggered, plain):
        o.updates_per_second = 20.0
    for frame in range(9):
        staggered.update(1 / 60)
        plain.update(1 / 60)
        assert staggered._pending == [[1, 2], [2], []][frame % 3]
        if frame % 3 == 2:
            for g in range(3):
                torch.testing.assert_close(staggered.state[g].time, plain.state[g].time,
                                           rtol=0, atol=0)
                assert_maps_close(staggered.maps[g].displacement, staggered.maps[g].normal,
                                  staggered.state[g].foam, plain.maps[g].displacement,
                                  plain.maps[g].normal, plain.state[g].foam)


def test_checkpoint_restore_and_resize_keep_parity():
    """A snapshot records every size; restored into a session of another
    size, the next updates equal the unbroken run's bit for bit. A resize to
    (32, 16, 16) regroups the cascades, restarts the clock and keeps parity
    with the JAX package."""
    jp, o = mixed()
    for _ in range(3):
        o.update(DT)
    snap = o.checkpoint()
    assert snap["map_size"] == list(SIZES) and len(snap["state"]) == 3
    want = [o.update(DT) for _ in range(2)][-1]

    fresh = T.Ocean(params=scene_params()[1], map_size=16, updates_per_second=0, device="cpu")
    fresh.restore(snap)
    assert fresh.groups == o.groups
    got = [fresh.update(DT) for _ in range(2)][-1]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.displacement, b.displacement, rtol=0, atol=0)
        torch.testing.assert_close(a.normal, b.normal, rtol=0, atol=0)

    o.resize((32, 16, 16))
    assert o.groups == ((32, (0,)), (16, (1, 2)))
    assert [m.displacement.shape[-1] for m in o.maps] == [32, 16]
    jaxes = jax_groups(jp, o)
    for _ in range(3):
        o.update(DT)
        for jo in jaxes:
            jo.update(DT)
    assert_groups_match_jax(o, jaxes)

    o.resize(16)                                     # back to one size: the one-size path
    assert type(o.maps) is T.OceanMaps and o.groups == ((16, (0, 1, 2)),)
    o.resize((16, 32, 16))
    o.set_cascades(scene_params()[1])                # keeps each cascade's size
    assert o.groups == ((16, (0, 2)), (32, (1,))) and o.map_sizes == (16, 32, 16)
    assert "Wave Resolution: 16x16, 32x32   Step: fused/fused" in observability.panel(o)
    with pytest.raises(ValueError, match="3 sizes for 2 cascades"):
        o.set_cascades(scene_params()[1].map(lambda x: x[:2]))


def test_each_step_group_is_a_span_inside_the_step():
    _, o = mixed()
    o.update(DT)
    with observability.tracing():
        observability.reset()
        for _ in range(2):
            o.update(DT)
        snap = observability.snapshot()
        spans = observability.spans()
    assert snap["counters"]["ocean.step_groups"] == 6
    assert snap["spans"]["ocean.step_group"]["count"] == 6
    assert {s.parent for s in spans if s.name == "ocean.step_group"} == {"ocean.step"}


def _mesh():
    return parallel.build_mesh([torch.device("cpu")] * 2, rows=1)


CONSUMERS = {
    "SceneRenderer.render": lambda o: SceneRenderer(16, 8, flat=True).render(
        o.maps, o.params.map_scales(), o.water_color, o.foam_color, (0.0, 5.0, 0.0), -10.0, 0.0),
    "SpraySession.advance": lambda o: SpraySession(64, device="cpu").advance(
        o.maps, o.params.map_scales(), DT),
    "make_batched_step": lambda o: make_batched_step(SceneRenderer(16, 8, flat=True),
                                                     o.config, None, 2),
    "MapStreamer": lambda o: next(MapStreamer(lambda: o.update(DT)).stream(1)),
    "preview_maps": lambda o: preview_maps(o.maps),
    "shard_state": lambda o: parallel.sharding.shard_state(_mesh(), o.state),
    "make_multichip_init": lambda o: parallel.sharding.make_multichip_init(_mesh(), o.config),
    "make_multichip_step": lambda o: parallel.sharding.make_multichip_step(_mesh(), o.config),
    "render_geometry_sharded": lambda o: parallel.sharding.render_geometry_sharded(
        _mesh(), o.maps, o.params.map_scales()),
    "LiveViewer": lambda o: LiveViewer(o, output=None),
    "WebViewer": lambda o: WebViewer(o),
}


@pytest.mark.parametrize("consumer", sorted(CONSUMERS))
def test_consumers_of_stacked_maps_refuse_a_mixed_session(consumer):
    _, o = mixed()
    o.update(DT)
    with pytest.raises(ValueError, match=f"{consumer}.*64x64, 32x32, 16x16"):
        CONSUMERS[consumer](o)


@pytest.mark.parametrize("map_size", [32, (32, 32, 32)], ids=["int", "equal_sizes"])
def test_one_size_session_runs_one_step_an_update(map_size, monkeypatch):
    """The one-size path, pinned: one `step` call an update, the bare
    `SimConfig`, `OceanState` and `OceanMaps`, and no group form bound."""
    calls = []
    real = tocean.step

    def spy(*args):
        calls.append(args[0])
        return real(*args)
    monkeypatch.setattr(tocean, "step", spy)
    o = T.Ocean(map_size=map_size, updates_per_second=0, device="cpu")
    assert type(o.config) is T.SimConfig and o.config == T.SimConfig(map_size=32)
    assert type(o.state) is T.OceanState and type(o.maps) is T.OceanMaps
    assert o.groups == ((32, (0, 1, 2)),) and not set(vars(o)) & set(o._GROUP_FORMS)
    for k in range(4):
        maps = o.update(DT)
        assert type(maps) is T.OceanMaps and len(calls) == k + 1
    assert all(c is o.config for c in calls)
    o.resize((16, 32, 16))
    o.update(DT)
    assert len(calls) == 4 + 2                       # a mixed update: one step a group
    o.resize(32)
    o.update(DT)
    assert len(calls) == 7 and type(o.maps) is T.OceanMaps
