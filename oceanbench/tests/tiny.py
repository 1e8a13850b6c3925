"""A copy of the benchmark at a size a CPU test holds, for the harness's tests.

`tiny_copy(tmp)` copies `BENCHMARK.json` and the benchmark's folder under
`tmp`, and cuts every configuration and workload there to a few texels,
particles and pixels; `run(cell, ...)` drives a run on the CPU with the
card's look skipped.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import torch

from oceanbench.core import harness, manifest

ROOT = manifest.ROOT
SEED = 2 ** 31 + 977          # larger than 32 signed bits hold, as the driver's are


def tiny_copy(tmp: pathlib.Path, map_size: int = 32) -> pathlib.Path:
    shutil.copytree(ROOT / "oceanbench", tmp / "oceanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in bench["workloads"]}
    for path in sorted((tmp / "oceanbench" / "workloads").glob("*.json")):
        wl = json.loads(path.read_text())
        if wl["name"] not in listed:     # a mix kept for a later cell: driven here too
            bench["workloads"].append({"name": wl["name"], "config": wl["config"],
                                       "traffic": wl["name"].split(".", 1)[1], "chips": 1,
                                       "why": "kept for a later cell"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        path = tmp / c["file"]
        cfg = json.loads(path.read_text())
        cfg["map_size"] = map_size
        if "spray" in cfg:
            cfg["spray"]["particles"] = 64
        path.write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        path = tmp / "oceanbench" / "workloads" / f"{w['name']}.json"
        wl = json.loads(path.read_text())
        if "width" in wl:
            wl["width"], wl["height"] = 64, 36
        wl["judge"]["octave_from"] = 2
        path.write_text(json.dumps(wl))
    return tmp


def workload_names() -> list:
    """Every mix under the benchmark's folder, those that no cell runs yet too."""
    return sorted(p.stem for p in (ROOT / "oceanbench" / "workloads").glob("*.json"))


def run(root: pathlib.Path, cell: str, seconds: float = 0.4, control: bool = False,
        seed: int = SEED) -> dict:
    torch.set_num_threads(1)
    found = manifest.find_cell(cell, root=root)
    return harness.run_cell(found, seed, seconds, False, device="cpu", check_card=False,
                            control=control)
