"""Readings that the limits of `correct` are set from: the program's and the control's, one process a cell.

    python3 oceanbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> ... \
        [--control <k>]

For each seed: the cell's set-up, a window of `--seconds` at the cell's own
load, then the judge's numbers for the program and, for the first `k`
seeds, for the control (the reference one precision lower, in the
program's place) on the same samples. One JSON line a seed, then a summary:
per number the largest program reading (the lower reading), the smallest
control reading (the upper) and the limit in force. The benchmark's runs
never run this; it needs a card.
"""
import argparse
import gc
import json
import pathlib
import sys
import time

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from oceanbench.core import harness, manifest, records  # noqa: E402


def worst(per_sample: list) -> dict:
    out = {}
    for _, nums in per_sample:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    cell = manifest.find_cell(args.workload)
    harness.require_card(torch, cell.entry["chips"])
    device = torch.device("cuda", 0)
    lower, upper = {}, {}
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        rec = records.Records(cell=cell, seed=seed, seconds=args.seconds, torch=torch)
        driver = cell.driver.Driver(cell, seed, device, rec)
        driver.setup()
        harness.measure(rec, driver, args.seconds, True)
        driver.release()
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "ticks": driver.ticks_done,
                "samples": sum(t < driver.ticks_done for t in driver.held),
                "program": worst(driver.judge(control=False))}
        if i < args.control:
            line["control"] = worst(driver.judge(control=True))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in line.get("control", {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
        del driver, rec
        gc.collect()
        torch.cuda.empty_cache()
    limits = cell.workload["limits"]
    print(json.dumps({"summary": {k: {"lower": lower.get(k), "upper": upper.get(k),
                                      "ratio": (upper[k] / lower[k] if lower.get(k) and k in upper
                                                else None),
                                      "limit": limits.get(k)} for k in sorted(lower)},
                      "seeds": len(args.seeds), "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
