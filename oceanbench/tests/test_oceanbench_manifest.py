"""BENCHMARK.json and the files it names: the contract's shapes and
characters, and every piece found by name, a piece added in a copy too."""
import json
import re

import pytest

from oceanbench.core import manifest
from oceanbench.tests import tiny

ROOT = manifest.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
TEXT_RE = re.compile(r"^[^\t\n]{1,200}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "width",
               "expansion", "experts_per_token", "map_size", "tile_length", "particles",
               "width", "height", "cascades")


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH_RE.match(p) and ".." not in p
                                                  and not p.startswith("/")
                                                  for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT_RE.match(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_text_use_the_allowed_characters():
    named = BENCH["configs"] + BENCH["workloads"] + metrics()
    for entry in named:
        assert manifest.NAME_RE.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert manifest.NAME_RE.match(w["config"]) and manifest.NAME_RE.match(w["traffic"])
        assert TEXT_RE.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert TEXT_RE.match(c["source"]) and TEXT_RE.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(manifest.NAME_RE.match(k) for k in c["reduced"])
    for m in metrics():
        assert manifest.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in metrics()]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_entries():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT_RE.match(m["layer"])
    assert len(layers) >= 2
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_configs_are_files_under_paths_and_cut_no_width():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and not any(w in key for w in WIDTH_WORDS), key
            assert not key.endswith(("_dim", "_rank"))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_pieces_by_name(cell):
    found = manifest.find_cell(cell)
    assert found.config["name"] == found.entry["config"]
    assert hasattr(found.driver, "Driver")
    names = {m["name"] for m in found.end_to_end + found.per_layer}
    assert names == set(found.readers)
    assert all(callable(r.read) for r in found.readers.values())
    assert set(found.workload["limits"]) >= {"maps_rms", "maps_max"}


def test_a_cell_added_in_a_copy_is_found_with_its_new_metric(tmp_path):
    root = tiny.tiny_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = json.loads((root / "oceanbench/workloads/scene_1024.sim.json").read_text())
    wl.update(name="scene_1024.sim_slow", dt=1 / 30)
    (root / "oceanbench/workloads/scene_1024.sim_slow.json").write_text(json.dumps(wl))
    (root / "oceanbench/metrics/frames_seen.py").write_text(
        "def read(rec):\n    return float(rec.frames)\n")
    bench["workloads"].append({"name": "scene_1024.sim_slow", "config": "scene_1024",
                               "traffic": "sim_slow", "chips": 1, "why": "a copy's cell"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "Session",
                               "moves": "frame_ms", "workloads": ["scene_1024.sim_slow"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    found = manifest.find_cell("scene_1024.sim_slow", root=root)
    assert found.workload["dt"] == 1 / 30 and "frames_seen" in found.readers
    assert found.readers["frames_seen"].read(type("R", (), {"frames": 7})()) == 7.0
    with pytest.raises(KeyError):
        manifest.find_cell("scene_1024.sim_slow")
