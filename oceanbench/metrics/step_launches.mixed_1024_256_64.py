"""step_launches.mixed_1024_256_64: K1's launches an update (the program's counter
`launches.fused_step` over its `ocean.update` spans, in the traced run's
instrumented window; `utils.observability.snapshot()`, taken by the driver
into `Records.facts`): a row and a column pass a size group. Nothing to read
where the program has no such counter or span."""


def read(rec):
    snap = rec.facts.get("observability") or {}
    launches = snap.get("counters", {}).get("launches.fused_step")
    updates = snap.get("spans", {}).get("ocean.update")
    if launches is None or not updates or not updates["count"]:
        return None
    return launches / updates["count"]
