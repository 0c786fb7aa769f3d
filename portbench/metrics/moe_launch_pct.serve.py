"""moe_launch_pct.serve: 100 x the host time spent launching the MoE
layers (the engine's ``moe`` span, ``moe_ns``) over the host time of the
model steps it nests in (``prefill_ns`` + ``decode_launch_ns``), all over
the window. None where the engine keeps no ``moe`` span (a dense
decoder)."""


def read(run: dict):
    stats = run.get("stats", {})
    steps = stats.get("prefill_ns", 0) + stats.get("decode_launch_ns", 0)
    if "moe_ns" not in stats or not steps:
        return None
    return 100.0 * stats["moe_ns"] / steps
