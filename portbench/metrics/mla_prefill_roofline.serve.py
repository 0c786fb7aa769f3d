"""mla_prefill_roofline.serve: the roofline time of the traced steps'
prefill attention, kernel #12's chunk form over each admission chunk's
valid rows (the row's cached slots and the chunk's own, once) and the
ViT's flash calls (#1), by ``lib/work_mla_moe.py``, over the device time
of those kernels in the trace (``mla_attention_kernel<4>`` or its mangled
name, ``flash_fwd``). Left out when the trace holds fewer launches of
them than the port's counters (``mla_chunk``, ``flash_fwd``) do."""

from portbench.lib.trace import kernel_seconds

# the form's kernel as the trace names it, demangled or not
KERNEL = ("mla_attention_kernel<4>", "mla_attention_kernelILi4E")


def read(run: dict):
    t = run.get("traced")
    if not t or not t["prefill_roof_s"] or "mla_chunk" not in t["launches"]:
        return None
    s12, n12 = kernel_seconds(t, *KERNEL)
    s1, n1 = kernel_seconds(t, "flash_fwd")
    launches = t["launches"]
    if n12 < launches["mla_chunk"] or n1 < launches.get("flash_fwd", 0) \
            or not s12 + s1:
        return None
    return 100.0 * t["prefill_roof_s"] / (s12 + s1)
