"""update_host_ms.ocean4_1024: the host clock around each `step_frames` call of the traced
run's window, no synchronize, over the call's frames (the mean). In this
device-bound loop the launch queue is full, so the host waits inside a call's
launches and this reads the card's pace a frame (back-pressure), not the
host's own cost of issuing a call; it falls below `step_device_ms` only
once the queue no longer fills."""


def read(rec):
    times = rec.host_ms.get("update")
    return sum(times) / (len(times) * rec.cell.workload["frames"]) if times else None
