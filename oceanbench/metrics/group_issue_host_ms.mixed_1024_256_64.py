"""group_issue_host_ms.mixed_1024_256_64: the mean host ms of the program's
`ocean.step_group` span, one a size group's `step` inside an update, over the
traced run's instrumented window (`utils.observability.snapshot()`, taken by
the driver into `Records.facts`): what the host pays to issue one group.
Nothing to read where the program has no such span."""


def read(rec):
    spans = (rec.facts.get("observability") or {}).get("spans", {})
    group = spans.get("ocean.step_group")
    return group["mean_ms"] if group and group["count"] else None
