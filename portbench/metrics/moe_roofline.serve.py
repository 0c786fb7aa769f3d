"""moe_roofline.serve: the roofline time of the traced steps' expert
products over their device time. The roofline (``lib/work_mla_moe.py``):
the larger of the distinct experts' weight bytes (three D x 1408 matrices
an expert with a token, per MoE layer and forward: the engine's
``moe_experts_hit``) plus each (token, expert) pair's row in and out
(``moe_assignments``) at 3.35 TB/s, and 6 x D x 1408 operations a pair at
989 TFLOP/s (``expert_roof_s`` of the traced record, which
``drivers/serve_mla_moe.py`` adds). The device time is that of the grouped
GEMMs (``torch._grouped_mm``: CUTLASS's grouped kernels, whose names hold
``GroupProblemShape``). Left out where the traced steps hold no pair or
no such kernel."""

from portbench.lib.trace import kernel_seconds

GEMMS = ("GroupProblemShape",)


def read(run: dict):
    t = run.get("traced")
    if not t or not t.get("expert_roof_s"):
        return None
    s, n = kernel_seconds(t, *GEMMS)
    if not n or not s:
        return None
    return 100.0 * t["expert_roof_s"] / s
