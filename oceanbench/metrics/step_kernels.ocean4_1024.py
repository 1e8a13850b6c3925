"""step_kernels.ocean4_1024: device kernels a frame that the `step_frames` calls launched
in the profiled window (the `oceanbench.update` spans): K1's row and column
pass a frame, and the call's few scalar operations spread over its frames.
A loop of `step` would read about the same; it catches a change in the
launch count, not the path."""


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.update")
    if not span or not span["count"] or not span["kernels"]:
        return None
    return span["kernels"] / (span["count"] * rec.cell.workload["frames"])
