"""admit_ms.serve: the mean host time of an admission, in ms: the
engine's ``admit`` span (``admit_ns``: the pixel upload, the ViT, the
prefill chunks and the read of the first token) over its ``admissions``,
both over the window. Every decoding row waits through it."""


def read(run: dict):
    stats = run.get("stats", {})
    n = stats.get("admissions", 0)
    return stats.get("admit_ns", 0) / n / 1e6 if n else None
