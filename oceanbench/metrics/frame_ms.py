"""frame_ms: the whole window's host-clock time, ending in a synchronize, over the frames
it completed (a frame in host memory, or an update in a sim cell). The sim
cells report it split by configuration, `frame_ms.<config>`: their runs
spread ten times apart, and a metric has one bound."""
from oceanbench.core import clock


def read(rec):
    return clock.window_ms(rec.t_start, rec.t_end, rec.frames) if rec.frames else None
