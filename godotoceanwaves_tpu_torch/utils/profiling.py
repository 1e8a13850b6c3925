"""Device profiling helpers: a torch.profiler trace and a per-call step timer.

Counterpart of the JAX package's `utils/profiling.py` (`jax.profiler` trace
capture and a chained-fetch step timer). Here the trace is
`torch.profiler` writing a Chrome trace (open it in Perfetto or
chrome://tracing) with the program's own spans on it, and the step timer
uses CUDA events (`utils.timing.time_cuda`) when the carry lives on the
card.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch

from ..models.cascade import require_device
from . import observability
from .hostio import _map_tree
from .timing import time_cuda


@contextlib.contextmanager
def trace(logdir: str, device: torch.device | str = "cuda"):
    """Capture a torch.profiler trace around a block into
    `<logdir>/trace.json`; yields the profiler. Traces the card's kernels
    as well as the host ops (device="cuda", the default, which raises
    without a card); device="cpu" traces host ops only.

    The program's spans are ranges on that trace. Beside it,
    `<logdir>/spans.json` holds the recorder's snapshot over the block
    (`observability.snapshot`: per-span totals and the counters, kernel
    launches among them; the recorder is reset when the block opens)."""
    device = require_device(device)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    observability.reset()
    with torch.profiler.profile(activities=activities) as prof:
        with observability.tracing():
            yield prof
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    snap = observability.snapshot()
    prof.export_chrome_trace(str(path / "trace.json"))
    (path / "spans.json").write_text(json.dumps(snap, indent=1))


def profile_step(step_fn, carry, iters: int = 32) -> dict[str, float]:
    """ms per call of a `carry -> carry` step, the calls chained.

    A carry on the card is timed with CUDA events (best of 3 x `iters`
    calls); one the caller put on the CPU, with the host clock over
    `iters` calls. A carry holding no tensor raises.
    """
    leaves = []
    _map_tree(carry, lambda x: leaves.append(x) or x)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not tensors:
        raise ValueError("profile_step needs a carry that holds a tensor")
    first = tensors[0]
    box = [carry]

    def call():
        box[0] = step_fn(box[0])

    if first.device.type == "cuda":
        ms = time_cuda(call, iters=iters)
    else:
        call()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        ms = (time.perf_counter() - t0) / iters * 1e3
    return {"ms_per_call": ms, "calls_per_second": 1e3 / ms if ms else 0.0}
