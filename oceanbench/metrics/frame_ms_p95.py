"""frame_ms_p95: the 95th percentile of the intervals between consecutive frames arriving
in host memory, over every frame of the window (host clock): stutter."""
from oceanbench.core import clock


def read(rec):
    gaps = clock.intervals_ms(rec.arrivals)
    return clock.p95(gaps) if len(gaps) >= 2 else None
