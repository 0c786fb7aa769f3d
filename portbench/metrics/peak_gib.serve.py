"""peak_gib.serve: ``torch.cuda.max_memory_allocated`` over the window (its
peak statistics reset at the window's start), in GiB."""


def read(run: dict):
    peak = run.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
