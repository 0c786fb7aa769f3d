"""The operations and bytes of a model whose decoder is the DeepSeek-V3
block, by ``lib/work.py``'s frozen rule (the larger of bytes over the
memory's peak rate and operations over the tensor cores' peak): a
``Sizes`` with ``lib/work.Sizes``' methods, and the counts of kernel #12's
two forms and of the expert products.

Operations count the active parameters: per token 2 x (attention matrices
+ the dense SwiGLU of the leading layers + per MoE layer the router, the
``num_experts_per_tok`` routed experts and the shared experts), the
vocabulary head once an admission and once a generated token, attention in
the absorbed form (2 products of 576 and 512 dims per attended (query,
key) pair and head: ``wkv_b`` is counted once a token among the matrices,
as the absorbed form uses it), and the ViT and ``mlp1`` per tile.

Kernel #12 reads each latent slot (576 bf16) once a launch: its decode form
per generated token and layer the row's slots (its own included), q (16
heads x 576), out (16 x 512) and the stored slot; its chunk form per chunk
and layer q and out of the chunk's valid rows and the slots they attend
(the cached ones and the chunk's own) once. The expert products, per MoE
layer: the distinct experts' three matrices once, each (token, expert)
pair's row in and out once, 6 x D x I operations a pair."""

from __future__ import annotations

from typing import Tuple

from portbench.lib import work
from portbench.lib.work import BF16, PEAK_BYTES_S, PEAK_FLOPS, causal_pairs, \
    roof_s


class Sizes(work.Sizes):
    """The sizes of one configuration file's ``model``."""

    def __init__(self, model: dict):
        super().__init__(model)
        lc = model["llm"]
        self.R = lc["kv_lora_rank"]
        self.rope = lc["qk_rope_head_dim"]
        self.nope, self.dv = lc["qk_nope_head_dim"], lc["v_head_dim"]
        self.E, self.k = lc["n_routed_experts"], lc["num_experts_per_tok"]
        self.Im = lc["moe_intermediate_size"]
        self.Is = self.Im * lc["n_shared_experts"]
        self.dense = lc["first_k_dense_replace"]
        self.dk = self.R + self.rope    # a latent slot
        self.H = self.Hq

    # ------------------------------------------------------------ matrices
    @property
    def attn_params(self) -> int:
        D, H = self.D, self.H
        return (D * H * (self.nope + self.rope) + D * self.dk
                + self.R * H * (self.nope + self.dv) + H * self.dv * D)

    @property
    def moe_active_params(self) -> int:
        """One MoE layer's parameters a token meets: the router, its routed
        experts, the shared experts."""
        return self.E * self.D + 3 * self.D * (self.k * self.Im + self.Is)

    @property
    def token_params(self) -> int:
        """Decoder matrix parameters a token meets over all layers."""
        return (self.L * self.attn_params + self.dense * 3 * self.D * self.I
                + (self.L - self.dense) * self.moe_active_params)

    @property
    def decoder_params(self) -> int:
        """Every decoder parameter (embedding, norms and head included)."""
        moe_layer = (self.E * self.D + self.E + 3 * self.E * self.D * self.Im
                     + 3 * self.D * self.Is)
        return (self.L * (self.attn_params + 2 * self.D + self.R)
                + self.dense * 3 * self.D * self.I
                + (self.L - self.dense) * moe_layer
                + 2 * self.V * self.D + self.D)

    @property
    def latent_bytes(self) -> int:
        """Latent pool bytes a token (every layer)."""
        return self.L * self.dk * BF16

    def llm_attn_flops(self, pairs: int) -> float:
        return 2.0 * self.H * (self.dk + self.R) * pairs * self.L

    # -------------------------------------------------------- kernel #12
    def mla_chunk_roof_s(self, m: int, c0: int) -> float:
        """#12's chunk form, every layer: m valid rows after c0 cached
        slots."""
        io = m * self.H * (self.dk + self.R) * BF16 + (c0 + m) * self.dk * BF16
        flops = 2.0 * self.H * (self.dk + self.R) * (m * c0 + m * (m + 1) / 2)
        return roof_s(io, flops) * self.L

    def mla_decode_bytes(self, context: int) -> float:
        """#12's decode form, every layer, one row attending ``context``
        slots (its own included): the slots, q, out and the stored slot."""
        return (context * self.dk + self.H * (self.dk + self.R) + self.dk) \
            * BF16 * self.L

    # ------------------------------------------------------------ experts
    def expert_roof_s(self, assignments: float, experts_hit: float) -> float:
        """The expert products of ``assignments`` (token, expert) pairs over
        ``experts_hit`` (expert, layer, forward) groups with a token."""
        nbytes = (experts_hit * 3 * self.D * self.Im
                  + assignments * 2 * self.D) * BF16
        return max(nbytes / PEAK_BYTES_S,
                   6.0 * self.D * self.Im * assignments / PEAK_FLOPS)

    # ------------------------------------------------------------- serving
    def prefill(self, S: int, cached: int, chunk: int, vit_tiles: int
                ) -> Tuple[float, float]:
        """(useful operations, roofline seconds of #12's chunk form and the
        ViT's #1) of one admission."""
        n = S - cached
        flops = 2.0 * self.token_params * n + 2.0 * self.head_params
        flops += self.llm_attn_flops(causal_pairs(cached, S))
        flops += vit_tiles * self.tile_flops()
        roof = self.vit_attn_roof_s(vit_tiles) if vit_tiles else 0.0
        for c0 in range(cached, S, chunk):
            roof += self.mla_chunk_roof_s(min(chunk, S - c0), c0)
        return flops, roof

    def decode_token(self, context: int) -> Tuple[float, float, float]:
        """(useful operations, bytes #12's decode form moves, its
        operations) of one generated token attending ``context`` slots."""
        attn = self.llm_attn_flops(context)
        flops = 2.0 * (self.token_params + self.head_params) + attn
        return flops, self.mla_decode_bytes(context), attn
