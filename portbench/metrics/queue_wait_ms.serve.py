"""queue_wait_ms.serve: the mean time a request admitted in the window
waited in the engine's queue, from its submit to the start of the plan
that admitted it, in ms: the engine's ``queue_wait_ns`` over its
``admissions`` (both counters over the window)."""


def read(run: dict):
    stats = run.get("stats", {})
    n = stats.get("admissions", 0)
    return stats.get("queue_wait_ns", 0) / n / 1e6 if n else None
