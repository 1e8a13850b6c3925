"""update_host_ms: the host clock around each `Ocean.update` call of the traced run's
window, no synchronize: what the host pays to issue an update (the mean)."""


def read(rec):
    times = rec.host_ms.get("update")
    return sum(times) / len(times) if times else None
