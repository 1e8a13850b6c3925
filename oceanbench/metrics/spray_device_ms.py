"""spray_device_ms: CUDA events around each `SpraySession.advance` call of the traced
run's window: the mean, in ms."""


def read(rec):
    times = rec.device_ms.get("spray")
    return sum(times) / len(times) if times else None
