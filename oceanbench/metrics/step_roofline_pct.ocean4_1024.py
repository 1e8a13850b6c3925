"""step_roofline_pct.ocean4_1024: a frame's share of the least time of a call's work (the
spectra, omega and foam in once, every frame's maps out, the final foam out,
and K steps' FFT operations, at the H100 SXM's published peaks;
`roofline.frames_bound`) over `step_device_ms.ocean4_1024`, in percent."""
from oceanbench.core import roofline


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.update")
    if not span or not span["count"] or span["device_ms"] <= 0.0:
        return None
    config, frames = rec.cell.config, rec.cell.workload["frames"]
    least_ms, _ = roofline.frames_bound(len(config["cascades"]), config["map_size"],
                                        config["map_dtype"], frames)
    return 100.0 * least_ms / (span["device_ms"] / (span["count"] * frames))
