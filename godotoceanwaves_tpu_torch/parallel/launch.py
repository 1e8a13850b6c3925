"""Start worker processes that drive one mesh together, on one machine.

    from godotoceanwaves_tpu_torch.parallel import launch
    result = launch.run(fn, 4, devices=["cpu"] * 4, args=(...))

Each worker is a fresh interpreter (the `spawn` start method). It joins the
process group through a `FileStore` in a new temporary directory (no TCP
port, so concurrent runs never collide), on its own device: NCCL for a
CUDA device, gloo for the CPU, unless `backend` says otherwise. A CPU
worker runs one intra-op thread, so the workers do not oversubscribe the
cores. Then it calls `fn(*args)`, waits for the others at a barrier and
leaves the group. `run` returns rank 0's result.

`fn` and `args` are pickled: `fn` lives at the top level of a module the
workers can import (a module of the port or a `*_torch` entry file; a
module that imports JAX would import it in every worker), and the result
is a picklable host value. A worker that raises, exits without a result or
is still running at `timeout_s` makes `run` raise with its traceback (for a
hung worker, the stacks of its threads); the other workers are stopped.
Every worker has ended when `run` returns or raises.
"""
from __future__ import annotations

import faulthandler
import multiprocessing
import os
import queue as queue_mod
import shutil
import signal
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from . import multihost

_DRAIN_S = 1.0        # a worker's last message may trail its exit by this long
_STACK_WAIT_S = 1.0   # for a hung worker to write its stacks
_JOIN_S = 30.0        # for a worker that reported to exit, before it is stopped


def _worker(rank: int, nprocs: int, init_method: str, device: str, backend: str | None,
            timeout_s: float, stack_file: str, fn: Callable, args: tuple, results) -> None:
    with open(stack_file, "w") as stacks:
        faulthandler.register(signal.SIGUSR1, file=stacks, all_threads=True)
        try:
            if torch.device(device).type == "cpu":
                torch.set_num_threads(1)
            multihost.initialize(init_method, nprocs, rank, backend=backend,
                                 local_device=device, timeout_s=timeout_s)
            try:
                out = fn(*args)
                torch.distributed.barrier()
            finally:
                multihost.shutdown()
            results.put((rank, True, out if rank == 0 else None))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            raise


def _stop(procs: list) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def run(fn: Callable, nprocs: int, *, devices: Sequence[torch.device | str] | None = None,
        backend: str | None = None, timeout_s: float = 600.0, args: tuple = ()) -> Any:
    """Run `fn(*args)` in `nprocs` workers, worker r on `devices[r]`
    (default: cuda:r, which raises without enough cards), and return rank
    0's result. `timeout_s` bounds the whole run and each collective."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < nprocs:
            raise RuntimeError(f"{nprocs} workers need {nprocs} CUDA devices, found {count}; "
                               "pass devices=['cpu'] * n to run on the CPU")
        devices = [f"cuda:{r}" for r in range(nprocs)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != nprocs:
        raise ValueError(f"{len(devices)} devices for {nprocs} workers")
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ocean_launch_")
    results = ctx.Queue()
    stack_files = [os.path.join(tmp, f"stacks_{r}.txt") for r in range(nprocs)]
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, nprocs, "file://" + os.path.join(tmp, "store"), devices[r],
                               backend, timeout_s, stack_files[r], fn, tuple(args), results))
             for r in range(nprocs)]
    done: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(done) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                hung = [r for r in range(nprocs) if r not in done]
                raise TimeoutError(f"workers {hung} of {nprocs} still running after "
                                   f"{timeout_s} s:\n" + _stacks(procs, stack_files, hung))
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if not dead:
                    continue
                try:
                    rank, ok, payload = results.get(timeout=_DRAIN_S)
                except queue_mod.Empty:
                    raise RuntimeError(f"worker {dead[0]} of {nprocs} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
            if not ok:
                raise RuntimeError(f"worker {rank} of {nprocs} failed:\n{payload}")
            done[rank] = payload
        for p in procs:
            p.join(min(timeout_s, _JOIN_S))
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return done[0]


def _stacks(procs: list, stack_files: list[str], ranks: list[int]) -> str:
    """The stacks of the given workers' threads, which each writes on SIGUSR1."""
    for r in ranks:
        if procs[r].is_alive():
            os.kill(procs[r].pid, signal.SIGUSR1)
    time.sleep(_STACK_WAIT_S)
    out = []
    for r in ranks:
        text = "(no stacks: it had not started)"
        if os.path.exists(stack_files[r]):
            with open(stack_files[r]) as f:
                text = f.read()
        out.append(f"--- worker {r} ---\n{text}")
    return "\n".join(out)
