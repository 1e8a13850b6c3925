"""One run of one cell: set-up, the measured window, the trace, the judge, the result line.

    python3 oceanbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run needs a CUDA card and fails without one: nothing falls back to the
CPU. `--trace 0` measures the cell's end-to-end metrics over a window of
`--seconds`. `--trace 1` runs the same window with the drivers' spans on
(host clock, CUDA events), then a short profiled window of the workload's
`trace_ticks`, and reports the per-layer metrics, the device's busy time
and a breakdown. Both then free the program's state, hand the samples that
the window held to the reference, and print one JSON line last on standard
output, its `checks` last: each number compared, with its limit. A run in
which JAX or the JAX package has been loaded by then prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

from . import clock, manifest, records, trace as trace_mod
from .judge import verdict

FORBIDDEN = ("jax", "jaxlib", "flax", "godotoceanwaves_tpu")
PROFILER_WARM_TICKS = 3


class NoCard(RuntimeError):
    pass


class Forbidden(RuntimeError):
    """Modules of JAX or the JAX package were loaded in the run's process."""


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"not read ({exc.__class__.__name__})"


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})


def require_card(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is available; the benchmark measures the card and "
                     "does not run on the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} "
                     "are available")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure(rec, driver, seconds: float, on_card: bool) -> None:
    """The window: ticks until `seconds` have passed, then the driver's
    drain (frames still on their way to the host) and a synchronize."""
    rec.t_start = time.perf_counter()
    while time.perf_counter() - rec.t_start < seconds:
        driver.tick()
    driver.drain()
    if on_card:
        rec.torch.cuda.synchronize()
    rec.t_end = time.perf_counter()


def run_cell(cell, seed: int, seconds: float, trace: bool, device=None,
             started: float | None = None, check_card: bool = True,
             control: bool = False, marks: tuple = ()) -> dict:
    """Runs `cell` once and returns the result line's object. `device` and
    `check_card=False` are for the benchmark's own tests, which drive a run
    on the CPU; there the window and the trace are not measured on a card,
    and no metric of a device is read. `marks` are (phase, host time it
    ended) of the set-up before the call."""
    started = clock.process_start() if started is None else started
    import torch
    if check_card:
        require_card(torch, cell.entry["chips"])
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
    rec = records.Records(cell=cell, seed=seed, seconds=seconds, torch=torch, device=device)
    for phase, at in marks:
        rec.mark(phase, at)
    rec.mark("CUDA context")
    driver = cell.driver.Driver(cell, seed, device, rec)
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    rec.mark("driver set-up")
    rec.mode = records.INSTRUMENTED if trace else records.TIMED
    t_window = time.perf_counter()
    rec.setup_s = t_window - started
    log("set-up: " + ", ".join(f"{name} {s:.3f} s" for name, s in rec.phases(started)))
    measure(rec, driver, seconds, on_card)
    attempted = rec.frames
    if on_card:
        rec.window_peak_bytes = rec.peak_less_held()
        rec.resolve_events()
    if trace and on_card:
        rec.mode = records.PROFILED
        warm = lambda: [driver.tick() for _ in range(PROFILER_WARM_TICKS)]
        window_frames = rec.frames
        with trace_mod.profiled(torch, warm) as holder:
            for _ in range(cell.workload["trace_ticks"]):
                driver.tick()
            driver.drain()
        rec.mode = records.TIMED
        rec.frames = window_frames
        rec.trace = trace_mod.summarize(holder.prof.events())
        del holder
    peak = max(setup_peak, rec.peak_less_held()) if on_card else None
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec) if on_card else None
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    per_sample = driver.judge(control=control)
    expected = {t for t in driver.sample_ticks if t < driver.ticks_done}
    checks, failed = verdict(per_sample, cell.workload["limits"], expected)
    correct = failed == 0 and attempted > 0
    log(f"judge: {len(per_sample)} sampled ticks of {driver.ticks_done} compared in "
        f"{time.perf_counter() - t_judge:.1f} s")
    found = forbidden_modules()
    if found:
        raise Forbidden(f"modules of JAX or the JAX package are loaded: {found}")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": int(peak),
                            "power_limit": card_line().split(",")[-1].strip()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": None}
    if rec.trace is not None:
        result["device"].update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, started: float | None = None) -> int:
    started = clock.process_start() if started is None else started
    t_main = time.perf_counter()
    args = parse(argv)
    try:
        cell = manifest.find_cell(args.workload)
        marks = (("interpreter and the harness's imports (torch)", t_main),
                 ("the cell's modules", time.perf_counter()))
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), started=started,
                          marks=marks)
    except NoCard as exc:
        log(f"oceanbench: {exc}")
        return 2
    except Forbidden as exc:
        log(f"oceanbench: {exc}; no result")
        return 3
    card = card_line()
    log(f"card: {card}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
