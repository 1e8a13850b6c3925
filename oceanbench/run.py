"""Run one cell of the benchmark once, on the card, and print its result line.

    python3 oceanbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. See `core/harness.py` for what a run does and
`BENCHMARK.json` for the cells.
"""
import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from oceanbench.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
