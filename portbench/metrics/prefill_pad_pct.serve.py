"""prefill_pad_pct.serve: 100 x the padding tokens of the engine's prefill
chunks (``prefill_pad_tokens``) over all their tokens (with the valid
``prefill_tokens``), both over the window."""


def read(run: dict):
    stats = run.get("stats", {})
    pad = stats.get("prefill_pad_tokens", 0)
    total = stats.get("prefill_tokens", 0) + pad
    return 100.0 * pad / total if total else None
