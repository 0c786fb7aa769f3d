"""The DeepSeek-V3 decoder block (Kimi-VL-A3B's language model): latent
attention (MLA) and a mixture of experts, behind the same InternVL front
(ViT, pixel shuffle, ``mlp1``) and V2PE positions as the dense decoders.

Written from the published ``DeepseekV3`` layers (``transformers``'
``models/deepseek_v3/modeling_deepseek_v3.py``) with the port's names: per
layer ``attention_norm``, ``wq`` (no q low-rank: D -> H x (nope + rope)),
``wkv_a`` (``kv_a_proj_with_mqa``: D -> latent + rope), ``kv_norm``
(``kv_a_layernorm``), ``wkv_b`` (latent -> H x (nope + v)), ``wo``,
``ffn_norm``; the first ``first_k_dense_replace`` layers a SwiGLU ``w1`` /
``w3`` / ``w2``, the others ``gate`` (the router's (E, D)), ``gate_bias``
(``e_score_correction_bias``), the stacked routed experts ``experts_w1`` /
``experts_w3`` (E, I, D) and ``experts_w2`` (E, D, I), and the shared
experts' SwiGLU ``shared_w1`` / ``shared_w3`` / ``shared_w2``. The rotary
key (64 dims, one for all heads) and the queries' rotary dims turn at the
tokens' V2PE positions; with ``rope_interleave`` (the published setting)
each is first de-interleaved (even dims, then odd), then rotated by halves,
as the published ``apply_rotary_pos_emb_interleave``.

Without a cache (a full forward: tests, evaluation) the attention is the
published one, K and V expanded per head by ``wkv_b``, in plain PyTorch.
With a paged cache, which is then a latent pool
(``infer/paged_kv.PagedKVCache.latents``), it runs absorbed: ``W_UK`` of
``wkv_b`` turns ``q_nope`` into latent space, the query (latent +
rope, 576 wide) attends the pool's slots through kernel #12
(``ops/mla_attention.py``), and ``W_UV`` turns the latent output back.
One token a row (decode): the kernel stores the step's latent and attends
it in one launch. A chunk (chunked prefill): its latents are scattered
into the pool, then the kernel's chunk form attends the cached pages and
the chunk, causal. Two to sixteen tokens a row (speculative verify) are
not supported.

The MoE layers run ``ops/moe.py``: routing in float32, grouped products
over the experts, no token dropped, no host read. ``spans`` (the engine's
``SpanRecorder``, set by it) times each MoE layer's launching as ``moe``;
``moe_counts`` (3,) int64 on the device, made at the first MoE layer,
accumulates (token, expert) pairs, experts hit and the busiest expert's
tokens, summed over layers and forwards; the engine reads it with its
harvest. ``route_log``, when a list, receives each MoE layer's expert
choices ((tokens, k) int64 on the device, in layer order; nothing read
back): the engine's ``record_routes`` keeps each served token's."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from v2pe_tpu_torch.core.config import MLAConfig
from v2pe_tpu_torch.infer import paged_kv
from v2pe_tpu_torch.ops import mla_attention as mla
from v2pe_tpu_torch.ops import moe
from v2pe_tpu_torch.ops.norms import rms_norm
from v2pe_tpu_torch.ops.rope import (apply_rotary, compute_rope_cos_sin,
                                     scale_positions)

# the published kv_a_layernorm keeps DeepseekV3RMSNorm's default eps (the
# layers' norms take rms_norm_eps)
KV_NORM_EPS = 1e-6


class DeepseekV3Layer(nn.Module):
    def __init__(self, cfg: MLAConfig, layer: int):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.attention_norm = nn.Parameter(torch.ones(D))
        self.ffn_norm = nn.Parameter(torch.ones(D))
        self.wq = nn.Linear(D, H * cfg.qk_head_dim, bias=False)
        self.wkv_a = nn.Linear(D, cfg.latent_dim, bias=False)
        self.kv_norm = nn.Parameter(torch.ones(cfg.kv_lora_rank))
        self.wkv_b = nn.Linear(cfg.kv_lora_rank,
                               H * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                               bias=False)
        self.wo = nn.Linear(H * cfg.v_head_dim, D, bias=False)
        self.is_moe = layer >= cfg.first_k_dense_replace
        if not self.is_moe:
            I = cfg.intermediate_size
            self.w1 = nn.Linear(D, I, bias=False)
            self.w3 = nn.Linear(D, I, bias=False)
            self.w2 = nn.Linear(I, D, bias=False)
            return
        E, Im = cfg.n_routed_experts, cfg.moe_intermediate_size
        Is = Im * cfg.n_shared_experts
        self.gate = nn.Parameter(torch.empty(E, D))
        self.gate_bias = nn.Parameter(torch.zeros(E))
        self.experts_w1 = nn.Parameter(torch.empty(E, Im, D))
        self.experts_w3 = nn.Parameter(torch.empty(E, Im, D))
        self.experts_w2 = nn.Parameter(torch.empty(E, D, Im))
        self.shared_w1 = nn.Linear(D, Is, bias=False)
        self.shared_w3 = nn.Linear(D, Is, bias=False)
        self.shared_w2 = nn.Linear(Is, D, bias=False)


class DeepseekV3Model(nn.Module):
    def __init__(self, cfg: MLAConfig):
        super().__init__()
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            DeepseekV3Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size))
        self.output = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.spans = None
        self.moe_counts: Optional[torch.Tensor] = None
        self.route_log: Optional[list] = None


def _rope(cfg: MLAConfig, x: torch.Tensor, cos, sin) -> torch.Tensor:
    if cfg.rope_interleave:
        d = x.shape[-1]
        x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    return apply_rotary(x, cos, sin)


def _project(p: DeepseekV3Layer, cfg: MLAConfig, x, cos, sin):
    """(q_nope (B, S, H, nope), q_pe (B, S, H, rope) rotated, the latent c
    (B, S, R) after kv_norm, k_pe (B, S, rope) rotated)."""
    B, S, _ = x.shape
    q = p.wq(x).view(B, S, cfg.num_attention_heads, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    c, k_pe = p.wkv_a(x).split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
    c = rms_norm(c, p.kv_norm, KV_NORM_EPS)
    return q_nope, _rope(cfg, q_pe, cos, sin), c, _rope(cfg, k_pe, cos, sin)


def _wkv_b(p: DeepseekV3Layer, cfg: MLAConfig):
    """(W_UK (H, nope, R), W_UV (H, v, R)) views of ``wkv_b``."""
    w = p.wkv_b.weight.view(cfg.num_attention_heads,
                            cfg.qk_nope_head_dim + cfg.v_head_dim, -1)
    return w[:, :cfg.qk_nope_head_dim], w[:, cfg.qk_nope_head_dim:]


def _full_attention(p, cfg: MLAConfig, q_nope, q_pe, c, k_pe, segment_ids,
                    positions):
    """The published (expanded) attention over the sequence itself: causal
    by ``positions`` within ``segment_ids``, float32 softmax."""
    B, S, H, _ = q_nope.shape
    kv = p.wkv_b(c).view(B, S, H, -1)
    k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], -1)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, -1)], -1)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * cfg.qk_head_dim ** -0.5
    pos = positions if positions is not None else \
        torch.arange(S, device=q.device).expand(B, S)
    keep = pos[:, None, :] <= pos[:, :, None]
    if segment_ids is not None:
        keep &= segment_ids[:, None, :] == segment_ids[:, :, None]
    s = s.masked_fill(~keep[:, None], float("-inf"))
    w = torch.softmax(s, -1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def attention_forward(p: DeepseekV3Layer, cfg: MLAConfig, x, cos, sin, *,
                      segment_ids=None, positions=None,
                      paged: Optional[tuple] = None) -> torch.Tensor:
    """One latent attention block; ``paged``: (latent pool cache, layer,
    where a chunk's latents go: ``mla_attention.latent_slots``, or None
    for one token a row)."""
    B, S, _ = x.shape
    q_nope, q_pe, c, k_pe = _project(p, cfg, x, cos, sin)
    if paged is None:
        out = _full_attention(p, cfg, q_nope, q_pe, c, k_pe, segment_ids,
                              positions)
        return p.wo(out.reshape(B, S, -1))
    cache, li, slots = paged
    w_uk, w_uv = _wkv_b(p, cfg)
    q = torch.cat([torch.einsum("bshd,hdr->bshr", q_nope, w_uk), q_pe],
                  -1).contiguous()
    lat = torch.cat([c, k_pe], -1)
    scale = cfg.qk_head_dim ** -0.5
    pool, table, lengths = cache.k_pages, cache.page_table, cache.lengths
    if S == 1:
        o = mla.mla_decode(q[:, 0], lat[:, 0].contiguous(), pool, table,
                           lengths, li, scale, cfg.kv_lora_rank)[:, None]
    elif S > 16:
        mla.store_latents(pool, li, slots, lat)
        o = mla.mla_chunk(q, pool, table, lengths, li, scale,
                          cfg.kv_lora_rank)
    else:
        raise NotImplementedError(
            "latent attention takes one token a row or a prefill chunk of "
            "more than 16; a step of 2-16 tokens (speculative verify) is "
            "not supported")
    out = torch.einsum("bshr,hdr->bshd", o, w_uv)
    return p.wo(out.reshape(B, S, -1))


def ffn_forward(p: DeepseekV3Layer, cfg: MLAConfig, h: torch.Tensor,
                counts: Optional[torch.Tensor],
                routes: Optional[list] = None) -> torch.Tensor:
    """The dense SwiGLU of a leading layer, or the routed experts plus the
    shared ones (their choices appended to ``routes`` when given)."""
    if not p.is_moe:
        return moe.swiglu(h, p.w1.weight, p.w3.weight, p.w2.weight)
    flat = h.reshape(-1, h.shape[-1])
    idx, w = moe.route(flat, p.gate, p.gate_bias,
                       top_k=cfg.num_experts_per_tok,
                       norm_topk_prob=cfg.norm_topk_prob,
                       scaling=cfg.routed_scaling_factor)
    if routes is not None:
        routes.append(idx)
    y = moe.experts(flat, idx, w, p.experts_w1, p.experts_w3, p.experts_w2,
                    counts)
    y = y + moe.swiglu(flat, p.shared_w1.weight, p.shared_w3.weight,
                       p.shared_w2.weight)
    return y.view_as(h)


def _moe_counts(model: DeepseekV3Model, device) -> torch.Tensor:
    if model.moe_counts is None or model.moe_counts.device != device:
        # a normal tensor, which serving (inference mode) and a plain
        # no-grad forward both update in place
        with torch.inference_mode(False):
            model.moe_counts = torch.zeros(3, dtype=torch.int64,
                                           device=device)
    return model.moe_counts


def layer_forward(p: DeepseekV3Layer, cfg: MLAConfig, x, cos, sin, *,
                  counts=None, spans=None, routes=None, **kw) -> torch.Tensor:
    x = x + attention_forward(p, cfg, rms_norm(x, p.attention_norm,
                                               cfg.rms_norm_eps),
                              cos, sin, **kw)
    h = rms_norm(x, p.ffn_norm, cfg.rms_norm_eps)
    timed = spans.span("moe") if spans is not None and p.is_moe else \
        contextlib.nullcontext()
    with timed:
        return x + ffn_forward(p, cfg, h, counts, routes)


def llm_forward(model: DeepseekV3Model, cfg: MLAConfig, *,
                input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                rope_pos_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                paged_cache: Optional[paged_kv.PagedKVCache] = None,
                paged_attend_cache: bool = False,
                return_hidden: bool = False, **unsupported):
    """``internlm2.llm_forward``'s interface for the DeepSeek-V3 decoder:
    (fp32 logits or the final hidden states, the paged cache with its pool
    written and its lengths NOT advanced). With ``paged_cache`` (a latent
    pool) a chunk always attends the row's cached pages; without it, the
    sequence attends itself (causal by ``positions`` within
    ``segment_ids``). Refuses the dense decoder's other caches and remat."""
    if any(v not in (None, False) for v in unsupported.values()):
        raise NotImplementedError(
            f"the DeepSeek-V3 decoder takes no "
            f"{sorted(k for k, v in unsupported.items() if v)}")
    del paged_attend_cache  # the chunk form attends the pages always
    if inputs_embeds is None:
        inputs_embeds = model.tok_embeddings(input_ids)
    x = inputs_embeds
    B, S, _ = x.shape
    if rope_pos_ids is None:
        ar = torch.arange(S, dtype=torch.float32, device=x.device)
        rope_pos_ids = (paged_cache.lengths[:, None].float() + ar[None]) \
            if paged_cache is not None else ar.expand(B, S)
    pos, theta = scale_positions(
        rope_pos_ids.float(), cfg.qk_rope_head_dim, cfg.rope_theta,
        mode=cfg.rope_mode, scaling_factor=cfg.rope_scaling_factor,
        max_position_embeddings=cfg.max_position_embeddings, seq_len=S)
    cos, sin = compute_rope_cos_sin(pos, cfg.qk_rope_head_dim, theta)
    slots = None
    if paged_cache is not None and S > 1:
        valid = None if segment_ids is None else \
            (segment_ids != 0).sum(1, dtype=torch.int32)
        slots = mla.latent_slots(paged_cache.page_table, paged_cache.lengths,
                                 S, paged_cache.page_size, valid)
    counts = _moe_counts(model, x.device)
    for li, layer in enumerate(model.layers):
        paged = None if paged_cache is None else (paged_cache, li, slots)
        x = layer_forward(layer, cfg, x, cos, sin, counts=counts,
                          spans=model.spans, routes=model.route_log,
                          segment_ids=segment_ids,
                          positions=positions, paged=paged)
    x = rms_norm(x, model.norm, cfg.rms_norm_eps)
    if return_hidden:
        return x, paged_cache
    return F.linear(x.float(), model.output.weight.float()), paged_cache
