"""A short profiled window, reduced to what the per-layer metrics read.

`profiled(torch)` runs a block under torch.profiler (CPU and CUDA
activity) inside a `oceanbench.window` span; `summarize` reduces the events
to plain numbers: the device's busy time inside that span (the union of
every device operation's interval: kernels, copies, fills), the window's
length, the device operations that took most time, the longest idle gaps
with what the host was doing in each, and for each `oceanbench.*` span its
count, its kernels and their device time (the kernels launched by the
span's own host calls, matched by correlation id, a replayed CUDA graph's
included; copies and fills are not kernels).

This is the pattern of `chip_smoke.py`'s `profile_frames` and
`device_profile`, copied and widened to the union and the gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import json

WINDOW = "oceanbench.window"
SPAN_PREFIX = "oceanbench."
TOP = 10


@contextlib.contextmanager
def profiled(torch, warm=None):
    """Profile the block; yields a holder whose `.prof` is the finished
    profiler once the block has closed. `warm()` runs first under the
    profiler, outside the window's span, so that the profiler's own first
    buffer requests fall outside the window."""
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        prof = None

    holder = Holder()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if warm is not None:
            warm()
            torch.cuda.synchronize()
        with torch.autograd.profiler.record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    holder.prof = prof


def _is_device(e) -> bool:
    return getattr(getattr(e, "device_type", None), "name", "") in ("CUDA", "PrivateUse1")


def _is_annotation(e) -> bool:
    """A span's shadow on the device's timeline (kineto's gpu_user_annotation):
    no operation of the device."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(SPAN_PREFIX)


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _launched(span, calls, starts, device_by_id):
    """The device operations launched by the CUDA API calls (a kernel launch,
    a graph launch, a copy) made inside `span` on its thread, matched by
    correlation id, each once."""
    lo, hi = bisect.bisect_left(starts, span.time_range.start), bisect.bisect_left(
        starts, span.time_range.end)
    out = {}
    for c in calls[lo:hi]:
        if c.thread == span.thread:
            out.update((id(d), d) for d in device_by_id.get(c.id, ()))
    return list(out.values())


def _is_copy_or_fill(e) -> bool:
    return e.name.startswith(("Memcpy", "Memset"))


def _bytes(e):
    try:
        meta = json.loads("{" + (e.metadata_json or "") + "}") if e.metadata_json else {}
    except (ValueError, TypeError):
        return None
    value = meta.get("bytes")
    return int(value) if isinstance(value, (int, float)) else None


def _host_activity(cpu_events, t: float) -> str:
    """The innermost host event open at time t (a torch op or runtime call),
    with the innermost `oceanbench.*` span around it."""
    inner, span = None, None
    for e in cpu_events:
        s, f = e.time_range.start, e.time_range.end
        if s <= t < f:
            if e.name.startswith(SPAN_PREFIX) and e.name != WINDOW:
                if span is None or s >= span.time_range.start:
                    span = e
            elif inner is None or s >= inner.time_range.start:
                inner = e
    name = inner.name if inner is not None else "host between calls"
    return f"{name} in {span.name}" if span is not None else name


def summarize(events) -> dict:
    """Reduce profiler events (`prof.events()`) to the traced window's numbers."""
    windows = [e for e in events if e.name == WINDOW and not _is_device(e)]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device = [e for e in events if _is_device(e) and not _is_annotation(e)
              and e.time_range.end > w0 and e.time_range.start < w1]
    cpu = [e for e in events if not _is_device(e) and e.name != WINDOW]
    merged = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device])
    busy_us = sum(e - s for s, e in merged)

    by_name: dict[str, float] = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    edges = [w0] + [v for s, e in merged for v in (s, e)] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    idle = [[_host_activity(cpu, start + 0.5 * length), length / 1e6] for length, start in gaps]

    device_by_id: dict[int, list] = {}
    for e in device:
        device_by_id.setdefault(e.id, []).append(e)
    calls = sorted((e for e in cpu if e.name.startswith("cu") and e.id in device_by_id),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in calls]
    spans: dict[str, dict] = {}
    for e in cpu:
        if not e.name.startswith(SPAN_PREFIX) or e.time_range.start < w0:
            continue
        ops = [d for d in _launched(e, calls, starts, device_by_id)
               if not _is_copy_or_fill(d)]
        s = spans.setdefault(e.name, {"count": 0, "kernels": 0, "device_ms": 0.0})
        s["count"] += 1
        s["kernels"] += len(ops)
        s["device_ms"] += sum(d.time_range.end - d.time_range.start for d in ops) / 1e3

    copies = [e for e in device if "DtoH" in e.name or "Device -> Pinned" in e.name]
    sizes = [_bytes(e) for e in copies]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_ops": [[name, us / 1e6] for name, us in top],
        "idle_gaps": idle,
        "spans": spans,
        "dtoh": {"count": len(copies),
                 "device_s": sum(e.time_range.end - e.time_range.start for e in copies) / 1e6,
                 "bytes": sum(sizes) if copies and all(v is not None for v in sizes) else None},
    }
