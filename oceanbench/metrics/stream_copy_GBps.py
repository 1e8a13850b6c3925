"""stream_copy_GBps: bytes of the profiled window's device-to-host copies over their
device time, from the trace (the copy's bytes where the trace gives them,
else two copies a frame of the maps' bytes): the link's part of streaming,
apart from the host's."""


def read(rec):
    dtoh = (rec.trace or {}).get("dtoh")
    if not dtoh or not dtoh["count"] or dtoh["device_s"] <= 0.0:
        return None
    moved = dtoh["bytes"]
    if moved is None:
        moved = dtoh["count"] / 2 * rec.facts["frame_bytes"]
    return moved / dtoh["device_s"] / 1e9
