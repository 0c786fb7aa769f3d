"""mfu.serve: the useful model operations of the traced steps over (their
wall time x 989 TFLOP/s): 2 x the decoder's matrix parameters per token
prefilled (not the prefix cache's tokens, not the chunks' padding) and
per token generated, the vocabulary head once an admission and once a
generated token, attention over the attended pairs, and the ViT and its
projector per tile whose tokens were prefilled."""

from portbench.lib.work import PEAK_FLOPS


def read(run: dict):
    t = run.get("traced")
    if not t or not t["flops"]:
        return None
    return 100.0 * t["flops"] / (t["window_s"] * PEAK_FLOPS)
