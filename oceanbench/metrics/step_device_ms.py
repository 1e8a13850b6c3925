"""step_device_ms: device time a update of the kernels that `Ocean.update`'s calls
launched, in the profiled window (torch.profiler, the `oceanbench.update`
spans)."""


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.update")
    if not span or not span["count"] or span["device_ms"] <= 0.0:
        return None
    return span["device_ms"] / span["count"]
