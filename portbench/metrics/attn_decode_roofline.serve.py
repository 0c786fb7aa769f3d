"""attn_decode_roofline.serve: the bytes each generated token's step must
move through the paged decode kernel (#5: the row's K/V context once, q,
the fresh k/v, out, lse and the stored slot, every layer) at 3.35 TB/s,
over #5's device time in the trace. Left out when the trace holds fewer
#5 launches than the port's counter does."""

from portbench.lib.trace import kernel_seconds
from portbench.lib.work import PEAK_BYTES_S, PEAK_FLOPS


def read(run: dict):
    t = run.get("traced")
    if not t or not t["decode_bytes"]:
        return None
    s5, n5 = kernel_seconds(t, "paged_decode")
    if n5 < t["launches"].get("paged_decode", 0) or not s5:
        return None
    attn = t["decode_attn_flops"]
    roof = max(t["decode_bytes"] / PEAK_BYTES_S, attn / PEAK_FLOPS)
    return 100.0 * roof / s5
