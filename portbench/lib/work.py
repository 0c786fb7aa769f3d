"""The yardstick: the card's peaks and the operations and bytes a model's
work needs, from its sizes alone.

The roofline rule is the port's own (``chip_smoke.py:roof`` and
``attention_roof``), frozen here: the least time the card could take is
the larger of the bytes over the memory's peak rate (every input byte
read once, every output byte written once) and the operations over the
peak rate of their type; an attention kernel runs two products of 2 D
operations per attended (query, key) pair and query head.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = 989e12   # bf16 tensor cores
PEAK_BYTES_S = 3.35e12
BF16 = 2


def roof_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS)


def causal_pairs(start: int, end: int) -> int:
    """(query, key) pairs of queries start..end-1 of one causal sequence,
    each seeing the keys up to itself."""
    return (end * (end + 1) - start * (start + 1)) // 2


class Sizes:
    """The sizes of one configuration file's ``model``."""

    def __init__(self, model: dict):
        v, lc = model["vision"], model["llm"]
        self.D = lc["hidden_size"]
        self.I = lc["intermediate_size"]
        self.L = lc["num_hidden_layers"]
        self.Hq = lc["num_attention_heads"]
        self.Hkv = lc["num_key_value_heads"]
        self.hd = self.D // self.Hq
        self.V = lc["vocab_size"]
        self.vD, self.vI = v["hidden_size"], v["intermediate_size"]
        self.vL, self.vH = v["num_hidden_layers"], v["num_attention_heads"]
        self.vhd = self.vD // self.vH
        self.patch = v["patch_size"]
        grid = v["image_size"] // v["patch_size"]
        self.tile_tokens = grid * grid + 1
        self.image_tokens = int(grid * grid * model["downsample_ratio"] ** 2)
        self.vin = v["num_channels"] * self.patch * self.patch

    # ------------------------------------------------------------ matrices
    @property
    def layer_params(self) -> int:
        """Matrix parameters of one decoder layer (wqkv, wo, w1, w3, w2)."""
        return (self.D * (self.Hq + 2 * self.Hkv) * self.hd
                + self.Hq * self.hd * self.D + 3 * self.D * self.I)

    @property
    def head_params(self) -> int:
        return self.V * self.D

    def llm_attn_flops(self, pairs: int) -> float:
        return 4.0 * self.hd * self.Hq * pairs * self.L

    # -------------------------------------------------------------- vision
    def tile_flops(self) -> float:
        """One tile through the ViT (patch embedding, the layers'
        products and attention), the pixel shuffle's projector mlp1."""
        layer = 3 * self.vD * self.vD + self.vD * self.vD \
            + 2 * self.vD * self.vI
        n = self.tile_tokens
        vit = 2.0 * (n - 1) * self.vin * self.vD + 2.0 * n * layer * self.vL \
            + 4.0 * self.vhd * self.vH * n * n * self.vL
        proj = 2.0 * self.image_tokens * (4 * self.vD * self.D
                                          + self.D * self.D)
        return vit + proj

    def vit_attn_roof_s(self, tiles: int) -> float:
        """Roofline of the ViT's flash calls (#1) for ``tiles`` tiles: per
        layer q, k, v, out (bf16) and lse (fp32) once, 2 products per
        pair and head."""
        n = self.tile_tokens
        io = 4 * tiles * n * self.vH * self.vhd * BF16 + tiles * self.vH * n * 4
        flops = 4.0 * self.vhd * self.vH * tiles * n * n
        return roof_s(io, flops) * self.vL

    # ------------------------------------------------------------- serving
    def prefill(self, S: int, cached: int, chunk: int, vit_tiles: int
                ) -> Tuple[float, float]:
        """(useful operations, attention roofline seconds of #1 and #6) of
        one admission: a prompt of S tokens whose first ``cached`` are
        served by shared pages, prefilled in chunks of ``chunk`` (padded),
        and ``vit_tiles`` tiles through the ViT."""
        n = S - cached
        flops = 2.0 * self.layer_params * self.L * n
        flops += 2.0 * self.head_params  # the last token's logits
        flops += self.llm_attn_flops(causal_pairs(cached, S))
        flops += vit_tiles * self.tile_flops()
        roof = self.vit_attn_roof_s(vit_tiles) if vit_tiles else 0.0
        qh, kh = self.Hq * self.hd * BF16, self.Hkv * self.hd * BF16
        for c0 in range(cached, S, chunk):
            m = min(chunk, S - c0)   # valid queries of this chunk
            # #1: the chunk's causal self-attention: q, k, v, out and lse
            # of its valid rows (the padding is the program's, not work
            # the inputs need)
            io1 = m * (2 * qh + 2 * kh) + m * self.Hq * 4
            roof += roof_s(io1, 4.0 * self.hd * self.Hq * m * (m + 1) / 2) \
                * self.L
            # #6: the chunk's valid rows over the c0 tokens already in the
            # row's pages
            io6 = m * (2 * qh + self.Hq * 4) + c0 * 2 * kh
            roof += roof_s(io6, 4.0 * self.hd * self.Hq * m * c0) * self.L
        return flops, roof

    def decode_token(self, context: int) -> Tuple[float, float, float]:
        """(useful operations, bytes #5 must move, #5's operations) of one
        generated token
        whose step attends ``context`` keys, its own included: per layer
        the row's K/V context once, q, the fresh k/v, out, lse and the
        stored slot."""
        attn = self.llm_attn_flops(context)
        flops = 2.0 * (self.layer_params * self.L + self.head_params) + attn
        qh, kh = self.Hq * self.hd * BF16, self.Hkv * self.hd * BF16
        per_layer = context * 2 * kh + 2 * qh + 2 * kh + self.Hq * 4 \
            + 2 * kh
        return flops, per_layer * self.L, attn
