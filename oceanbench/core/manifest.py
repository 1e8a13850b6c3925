"""Find a cell's pieces by name: its workload, configuration, driver and metric readers.

Every piece is a file of its own under the benchmark's folder, named after
the entry in `BENCHMARK.json` that uses it:

- `workloads/<cell>.json`: the traffic mix, naming its config and driver;
- `configs/<config>.json`: the configuration, as `BENCHMARK.json`'s `file`;
- `drivers/<driver>.py`: a `Driver` class that runs the mix; it reaches the
  program only through `core/program.py`: the objects it makes, or any public entry
  of the program by its dotted path (`program.entry("models.ocean.step_frames")`);
- `metrics/<metric>.py`: a `read(records)` function for one metric; a
  quantity split by cell family (`frame_ms.scene_1024`, where one bound or
  one `moves` cannot serve every cell) is read by `metrics/<quantity>.py`
  unless the split has a file of its own.

A later change adds a cell, a configuration, a metric, or a driver of
another entry of the program by adding files and entries; no file here or in
`core/program.py` needs an edit for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the BENCHMARK.json workload entry
    workload: dict         # workloads/<name>.json
    config: dict           # the configuration's file
    driver: ModuleType     # drivers/<driver>.py
    end_to_end: list       # BENCHMARK.json metrics this cell reports, with --trace 0
    per_layer: list        # ... with --trace 1
    readers: dict          # metric name -> module with read(records)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"oceanbench_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(bench_dir: Path, metric: str) -> Path:
    """`metrics/<metric>.py`, or for a split `<quantity>.<part>` without a
    file of its own, `metrics/<quantity>.py`."""
    own = bench_dir / "metrics" / f"{metric}.py"
    return own if own.is_file() else bench_dir / "metrics" / f"{metric.split('.')[0]}.py"


def find_cell(name: str, bench: dict | None = None, root: Path = ROOT,
              bench_dir: Path | None = None) -> Cell:
    """The cell `name` of `bench` (`root`'s BENCHMARK.json by default), with
    every file it names loaded from `bench_dir` (`root`/oceanbench)."""
    bench = load_benchmark(root) if bench is None else bench
    bench_dir = root / "oceanbench" if bench_dir is None else bench_dir
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}")
    entry = entries[name]
    with open(bench_dir / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[entry["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    if workload["config"] != entry["config"] or config["name"] != entry["config"]:
        raise ValueError(f"{name}: BENCHMARK.json, the workload file and the config file "
                         f"name different configurations")
    driver = load_module(bench_dir / "drivers" / f"{workload['driver']}.py",
                         f"driver_{workload['driver']}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    readers = {m["name"]: load_module(reader_path(bench_dir, m["name"]), f"metric_{m['name']}")
               for m in e2e + layer}
    return Cell(name, entry, workload, config, driver, e2e, layer, readers)
