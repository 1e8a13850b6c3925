"""step_roofline_pct.mixed_1024_256_64: the least time of an update's work, summed over its
size groups (each group's state in and maps and foam out, and its FFT's
operations, at its own map size; `roofline.step_bound`), over the device
time an update of the kernels inside the `oceanbench.update` spans (as
`step_device_ms`), in percent: K1's share of its roofline over the mixed
work."""
from oceanbench.core import roofline


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.update")
    if not span or not span["count"] or span["device_ms"] <= 0.0:
        return None
    config = rec.cell.config
    sizes = config["map_sizes"]
    least_ms = sum(roofline.step_bound(sizes.count(n), n, config["map_dtype"])[0]
                   for n in dict.fromkeys(sizes))
    return 100.0 * least_ms / (span["device_ms"] / span["count"])
