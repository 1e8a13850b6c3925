"""Captured CUDA graphs: the port's counterpart of `jax.jit` on the frame path.

The JAX package runs each frame program (the scene render, the spray step,
the K-frame step, the ANSI field) as one compiled dispatch. Eager PyTorch
launches every operation from Python instead, ~1,400-1,900 launches a
frame. `graphed(fn)` records `fn`'s launches once as a `torch.cuda.CUDAGraph`
and replays the recording on every later call: one graph launch, plus the
copies of the arguments into the graph's input buffers.

- The key of a graph is what `jax.jit` retraces on: the shape, dtype and
  device of each tensor argument and the value of every other argument
  (numbers, strings, tuples of them). Containers are walked: tuples, lists,
  dicts and dataclasses (`OceanMaps`, `OceanState`, `CascadeParams`,
  `SprayState`, `SprayParams`). A number that changes every call (a clock,
  a pose) must come as a tensor, or each call captures anew:
  `HostValues` stages such numbers to the card.
- The first call for a key runs `fn` eagerly on a side stream (its launches
  count and its result is returned; it fills every cache the capture then
  reads), then captures `fn` on the same inputs. A later call copies its
  tensors into the graph's input buffers and replays. A capture that fails
  raises; nothing goes on eagerly in its place.
- A result never aliases the graph's buffers: every output tensor is a copy
  the next replay does not overwrite, except an output that IS an input
  (state passed through), which comes back as the caller's own tensor.
- On CPU tensors `fn` runs as it is; `disabled()` runs it eagerly on the
  card too (`jax.disable_jit()`).
- `Recording(fn)` is one capture with no key, no warm-up run and no copies,
  for a caller that keeps the graph's inputs in buffers of its own and
  copies out what it hands on (a mixed session's group step,
  `models/ocean.py` `_GroupGraph`).
- Launch counts (`ops/_build.py` `LAUNCHES`): a launch recorded during a
  capture is not made, so it goes to the capture's tally
  (`_build.recording`); every replay counts the tally (`_build.made`).
- Cached device constants (`keep`) are held by the graph captured while
  they are read, so a cache eviction cannot free memory a replay reads.
- Spans and counters (`utils/observability.py`): a call on the card is the
  span `graph.<fn's name>`, holding `graph.copy_in`, `graph.launch` and
  `graph.copy_out` for a replay or `graph.capture`; counters
  `graph.copy_in_bytes` and `graph.copy_out_bytes` (each graph's sums,
  taken once at its capture); `HostValues.put` waiting for a pinned buffer
  is `host_values.wait`. `_build` counts every launch, made or replayed,
  as the counter `launches.<op>` too.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from ..ops import _build
from .observability import count, span

_state = threading.local()        # .capture: the _Capture this thread is recording
_capture_lock = threading.Lock()  # one capture at a time (torch.cuda.graph's stream is shared)
_disabled = 0                     # depth of open `disabled()` contexts


@contextlib.contextmanager
def disabled():
    """Run every `graphed` callable eagerly inside the block, on any thread
    (the counterpart of `jax.disable_jit()`); nests."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def enabled() -> bool:
    """False inside `disabled()`."""
    return _disabled == 0


@dataclasses.dataclass
class _Capture:
    tally: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    kept: list = dataclasses.field(default_factory=list)


def keep(value):
    """`value` (a cached device constant), held by the graph this thread is
    capturing, if any; returns it."""
    capture = getattr(_state, "capture", None)
    if capture is not None:
        capture.kept.append(value)
    return value


# --- argument trees -----------------------------------------------------------

def _flatten(tree, leaves: list):
    """The spec of `tree` (a graph's key where every static is hashable); its
    tensors are appended to `leaves`."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple((f.name, _flatten(getattr(tree, f.name), leaves))
                                  for f in dataclasses.fields(tree)))
    return ("static", tree)


def _unflatten(spec, leaves):
    """The tree of `spec` with its tensors taken in order from the iterator `leaves`."""
    kind, body = spec[0], spec[1:]
    if kind == "tensor":
        return next(leaves)
    if kind == "static":
        return body[0]
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in body[0]}
    if kind in (tuple, list):
        return kind(_unflatten(x, leaves) for x in body[0])
    return kind(**{name: _unflatten(v, leaves) for name, v in body[0]})


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: list          # the input buffers, in leaf order
    out_spec: tuple
    outputs: list         # the output buffers
    tally: collections.Counter
    kept: list            # cached constants the replay reads
    copy_in_bytes: int    # what a replay copies into `inputs`
    copy_out_bytes: int   # ... and clones out of `outputs`


def _results(out_spec, outputs: list, inputs: list, args: list):
    """The caller's result: outputs that are input buffers become the
    caller's tensors, the rest are copied out of the buffers."""
    where = {id(buf): arg for buf, arg in zip(inputs, args)}
    return _unflatten(out_spec, iter(where.get(id(t)) if id(t) in where else t.clone()
                                     for t in outputs))


class Pool:
    """One memory pool for the graphs of several `graphed` callables
    (`torch.cuda.graph_pool_handle()`, made at the first capture). Their
    graphs must replay on one stream, as a renderer's do."""

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle


class Graphed:
    """`fn` captured once per key as a CUDA graph and replayed (see the
    module's notes). `capture_seconds` lists each capture's time, warm-up
    run included."""

    def __init__(self, fn, pool: Pool | None = None):
        self.fn = fn
        self.pool = pool if pool is not None else Pool()
        self.capture_seconds: list[float] = []
        self._graphs: dict = {}
        self._lock = threading.Lock()     # one replay's copies in, launch and copies out
        self._span = f"graph.{getattr(fn, '__name__', type(fn).__name__)}"

    def __call__(self, *args, **kwargs):
        leaves: list = []
        spec = _flatten((args, kwargs), leaves)
        if not enabled() or not any(t.is_cuda for t in leaves):
            return self.fn(*args, **kwargs)
        try:
            hash(spec)
        except TypeError as e:
            raise TypeError("a graphed call takes tensors, containers of them and hashable "
                            f"values (the key), not {e}: pass a tensor or a tuple") from None
        with span(self._span):
            with self._lock:
                entry = self._graphs.get(spec)
                if entry is not None:
                    with span("graph.copy_in"):
                        for buf, t in zip(entry.inputs, leaves):
                            buf.copy_(t)
                    with span("graph.launch"):
                        entry.graph.replay()
                    _build.made(entry.tally)
                    count("graph.copy_in_bytes", entry.copy_in_bytes)
                    count("graph.copy_out_bytes", entry.copy_out_bytes)
                    with span("graph.copy_out"):
                        return _results(entry.out_spec, entry.outputs, entry.inputs, leaves)
            with span("graph.capture"):
                return self._capture(spec, leaves)

    def _capture(self, spec, leaves: list):
        t0 = time.perf_counter()
        device = next(t.device for t in leaves if t.is_cuda)
        with torch.cuda.device(device):
            inputs = [t.detach().clone(memory_format=torch.contiguous_format) for t in leaves]
            args, kwargs = _unflatten(spec, iter(inputs))
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                first = self.fn(*args, **kwargs)
            main.wait_stream(side)
            graph, capture = torch.cuda.CUDAGraph(), _Capture()
            with _capture_lock:
                _state.capture = capture
                try:
                    with _build.recording(capture.tally), torch.cuda.graph(
                            graph, pool=self.pool.get(), capture_error_mode="thread_local"):
                        out = self.fn(*args, **kwargs)
                finally:
                    _state.capture = None
            outputs: list = []
            out_spec = _flatten(out, outputs)
            first_leaves: list = []
            if _flatten(first, first_leaves) != out_spec:
                raise RuntimeError(f"{getattr(self.fn, '__name__', self.fn)} returned another "
                                   "structure under capture than in its warm-up run")
            copied = {id(t) for t in inputs}
            with self._lock:
                self._graphs[spec] = _Graph(
                    graph, inputs, out_spec, outputs, capture.tally, capture.kept,
                    copy_in_bytes=sum(t.nbytes for t in inputs),
                    copy_out_bytes=sum(t.nbytes for t in outputs if id(t) not in copied))
            result = _results(out_spec, first_leaves, inputs, leaves)
        self.capture_seconds.append(time.perf_counter() - t0)
        return result

    @property
    def num_graphs(self) -> int:
        return len(self._graphs)


class Recording:
    """`fn()` recorded once as a CUDA graph on the current device, for a
    caller that keeps the graph's inputs in buffers of its own.

    There is no warm-up run: the caller has run the same work eagerly just
    before, so every cache the capture reads is filled. `outputs` is what
    `fn` returned under capture: the graph's own buffers, which every replay
    rewrites. `replay()` launches the graph and counts its capture's
    launches (`_build.made`). Cached constants read under capture (`keep`)
    are held as a `Graphed` graph holds them. The graph has a memory pool
    of its own, freed with it."""

    def __init__(self, fn):
        self.graph, capture = torch.cuda.CUDAGraph(), _Capture()
        with span("graph.capture"), _capture_lock:
            _state.capture = capture
            try:
                with _build.recording(capture.tally), torch.cuda.graph(
                        self.graph, capture_error_mode="thread_local"):
                    self.outputs = fn()
            finally:
                _state.capture = None
        self.tally, self.kept = capture.tally, capture.kept

    def replay(self) -> None:
        self.graph.replay()
        _build.made(self.tally)


def graphed(fn, pool: Pool | None = None) -> Graphed:
    """`fn` as one captured CUDA graph per key on the card, as it is on the
    CPU. Graphs that share `pool` share its memory."""
    return Graphed(fn, pool)


class HostValues:
    """Host numbers to the card in one non-blocking copy a call.

    `put(values, device)` packs every number and sequence of numbers in
    `values` (rounded to fp32) into a pinned buffer, copies it to `device`
    without waiting, and returns `values` with each of them replaced by a
    view of the copy (0-d for a number, (k,) for a sequence); tensors pass
    as they are. Two pinned buffers alternate, and a buffer is written only
    once its last copy has finished, so the host never overwrites bytes a
    copy still reads."""

    def __init__(self):
        self._buffers: list[torch.Tensor] = []
        self._events: list = [None, None]
        self._slot = 0

    def put(self, values, device) -> list:
        flat, where = [], []
        for v in values:
            if isinstance(v, torch.Tensor):
                where.append(None)
                continue
            a = np.asarray(v, np.float32)
            where.append((len(flat), a.size, a.ndim == 0))
            flat.extend(a.reshape(-1).tolist())
        if not flat:
            return list(values)
        n = len(flat)
        if not self._buffers or self._buffers[0].numel() != n:
            self._buffers = [torch.empty(n, dtype=torch.float32, pin_memory=True)
                             for _ in range(2)]
            self._events = [None, None]
        slot = self._slot
        self._slot ^= 1
        if self._events[slot] is not None and not self._events[slot].query():
            with span("host_values.wait"):
                self._events[slot].synchronize()
        buf = self._buffers[slot]
        buf.numpy()[:] = flat
        dev = torch.empty(n, dtype=torch.float32, device=device)
        dev.copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev.device))
        self._events[slot] = event
        return [v if w is None else (dev[w[0]] if w[2] else dev[w[0]:w[0] + w[1]])
                for v, w in zip(values, where)]
