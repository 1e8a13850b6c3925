"""render_kernels: device kernels a rendered frame, counted in the profiled window's
trace (the kernels that the `oceanbench.render` spans' calls launched)."""


def read(rec):
    span = (rec.trace or {}).get("spans", {}).get("oceanbench.render")
    if not span or not span["count"] or not span["kernels"]:
        return None
    return span["kernels"] / span["count"]
