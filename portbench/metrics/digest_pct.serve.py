"""digest_pct.serve: 100 x the engine's ``digest`` span (the prefix
cache's blake2b over a request's pixels and its chain of page keys,
``digest_ns``) over its ``step`` span (``step_ns``: every scheduler step),
both over the window: the share of the scheduler's own time spent keying
the prefix cache."""


def read(run: dict):
    stats = run.get("stats", {})
    step = stats.get("step_ns", 0)
    return 100.0 * stats.get("digest_ns", 0) / step if step else None
