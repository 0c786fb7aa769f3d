"""decode_launch_ms.serve: the mean host time to issue one decode step, in
ms: the engine's ``decode_launch`` span (``decode_launch_ns``: issuing a
block's steps, up to its harvest) over its ``decode_steps`` (forwards),
both over the window."""


def read(run: dict):
    stats = run.get("stats", {})
    n = stats.get("decode_steps", 0)
    return stats.get("decode_launch_ns", 0) / n / 1e6 if n else None
