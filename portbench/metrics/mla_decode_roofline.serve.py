"""mla_decode_roofline.serve: the latent bytes each generated token's step
must move through kernel #12's decode form (the row's latent slots once,
its own included, q, out and the stored slot, every layer:
``lib/work_mla_moe.py``) at 3.35 TB/s, or its operations at 989 TFLOP/s
where they take longer, over the decode form's device time in the trace
(``mla_attention_kernel<1>`` or its mangled name). Left out when the trace
holds fewer of its launches than the port's counter (``mla_decode``)
does."""

from portbench.lib.trace import kernel_seconds
from portbench.lib.work import PEAK_BYTES_S, PEAK_FLOPS

# the form's kernel as the trace names it, demangled or not
KERNEL = ("mla_attention_kernel<1>", "mla_attention_kernelILi1E")


def read(run: dict):
    t = run.get("traced")
    if not t or not t["decode_bytes"] or "mla_decode" not in t["launches"]:
        return None
    s, n = kernel_seconds(t, *KERNEL)
    if n < t["launches"]["mla_decode"] or not s:
        return None
    roof = max(t["decode_bytes"] / PEAK_BYTES_S,
               t["decode_attn_flops"] / PEAK_FLOPS)
    return 100.0 * roof / s
