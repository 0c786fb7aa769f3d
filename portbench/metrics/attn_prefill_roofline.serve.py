"""attn_prefill_roofline.serve: the roofline time of the traced steps'
prefill attention (the ViT's flash calls, and each admission chunk's
causal self-attention (#1, flash_fwd) and its attention over the row's
cached pages (#6, paged_prefill)), by the frozen rule of
``portbench/lib/work.py``, over the device time of those kernels in the
trace. Left out when the trace holds fewer launches of them than the
port's counters do."""

from portbench.lib.trace import kernel_seconds


def read(run: dict):
    t = run.get("traced")
    if not t or not t["prefill_roof_s"]:
        return None
    s1, n1 = kernel_seconds(t, "flash_fwd")
    s6, n6 = kernel_seconds(t, "paged_prefill")
    launches = t["launches"]
    if n1 < launches.get("flash_fwd", 0) or \
            n6 < launches.get("paged_prefill", 0) or not s1 + s6:
        return None
    return 100.0 * t["prefill_roof_s"] / (s1 + s6)
