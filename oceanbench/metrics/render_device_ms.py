"""render_device_ms: CUDA events around each `SceneRenderer.render` call of the traced
run's window (one replayed graph, the splat included): the mean, in ms."""


def read(rec):
    times = rec.device_ms.get("render")
    return sum(times) / len(times) if times else None
