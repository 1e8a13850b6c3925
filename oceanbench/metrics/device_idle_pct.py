"""device_idle_pct: 100 less the share of the profiled window in which any operation ran
on the device (the union of kernels, copies and fills): the driver's idle
share, from the same `busy_s` and `window_s`. The profiler's own host work
stretches the gaps of a host-bound cell (`PERF.md` §5 gives both readings
for the sim cells)."""


def read(rec):
    if not rec.trace or rec.trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
