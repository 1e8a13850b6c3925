"""step_roofline_pct: the least time a step's work can take (its state in and maps and
foam out, each byte once, and its FFT's operations, at the H100 SXM's
published peaks; `core/roofline.py`) over the device time an update of the
kernels inside the `oceanbench.update` spans (as `step_device_ms`), in
percent."""
from oceanbench.core import roofline


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.update")
    if not span or not span["count"] or span["device_ms"] <= 0.0:
        return None
    config = rec.cell.config
    least_ms, _ = roofline.step_bound(len(config["cascades"]), config["map_size"],
                                      config["map_dtype"])
    return 100.0 * least_ms / (span["device_ms"] / span["count"])
