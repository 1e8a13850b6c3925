"""step_device_ms.ocean4_1024: device ms a frame of the kernels that the `step_frames`
calls launched in the profiled window (torch.profiler, the `oceanbench.update`
spans, one a call): a call's device time over its frames."""


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.update")
    if not span or not span["count"] or span["device_ms"] <= 0.0:
        return None
    return span["device_ms"] / (span["count"] * rec.cell.workload["frames"])
