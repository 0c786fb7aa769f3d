"""InternLM2 decoder (port of ``v2pe_tpu/models/internlm2.py``).

Fused ``wqkv`` in the interleaved GQA layout, V2PE rotary from float32
position ids applied in fp32, pre-RMSNorm layers with a SwiGLU MLP and fp32
logits. One ``nn.Module`` per layer; the dense KV cache is preallocated as
(L, B, max_len, Hkv, hd) tensors that the forward writes in place.

Without a cache, q's rotary is fused into the flash kernel (from the float32
ids) and k is rotated here. With a cache, a prompt (> 16 tokens) is written
into the cache first and attends over the whole buffer through the kernel;
a decode step (<= 16 tokens) attends over the cache and itself with one
softmax (``_two_part_decode_attention``) and is written after.

With a paged cache (``infer/paged_kv.py``) the pool is never copied: the
kernels of ``ops/paged_attention.py`` take the whole pool and the layer
index. One token per row: the store kernel writes the fresh k/v into the
row's page, then the decode kernel attends over the pages, fresh slot
included. Up to 16 tokens: the decode kernel folds the fresh k/v in
separately, then they are scattered into the pages. A longer prompt attends
to itself through the flash kernel (and, in chunked prefill, also to the
cached pages through the paged prefill kernel, merged by logsumexp), then
is scattered into the pages layer by layer.

Training (no cache, ``remat`` set) checkpoints with ``torch.utils.checkpoint``
as the JAX scan does with ``jax.checkpoint``: ``full`` per layer, ``block2``
/ ``block4`` per block of 2 / 4 layers (per layer when the depth is not a
multiple, as the JAX code falls back), ``attn_saved`` only the SwiGLU block
(the attention's residuals stay and its backward recomputes nothing),
``none`` nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from v2pe_tpu.core.config import LLMConfig
from v2pe_tpu_torch.infer import paged_kv
from v2pe_tpu_torch.ops import paged_attention as pa
from v2pe_tpu_torch.ops.attention import (flash_attention,
                                          flash_attention_with_lse)
from v2pe_tpu_torch.ops.norms import rms_norm
from v2pe_tpu_torch.ops.rope import (apply_rotary, compute_rope_cos_sin,
                                     scale_positions)


@dataclasses.dataclass
class KVCache:
    """Dense per-layer KV cache: k/v (L, B, max_len, Hkv, hd), filled in
    place; ``length`` slots are written so far."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @staticmethod
    def zeros(cfg: LLMConfig, batch: int, max_len: int,
              dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, max_len,
                 cfg.num_key_value_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)


class PagedStep(NamedTuple):
    """What one layer's attention needs of a paged cache: the cache (its
    lengths exclude this step's tokens), the layer index, each page-table
    entry's first slot (``default_slot_base``, made once per forward),
    where this step's tokens go (``paged_kv.token_slots``; None for one
    token per row, which the store kernel places), and whether a
    multi-token chunk also attends over the cached pages (chunked
    prefill)."""

    cache: paged_kv.PagedKVCache
    layer: int
    slot_base: torch.Tensor
    slots: Optional[tuple]
    attend_cache: bool


class LLMLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        qkv_out = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) \
            * cfg.head_dim
        self.attention_norm = nn.Parameter(torch.ones(D))
        self.ffn_norm = nn.Parameter(torch.ones(D))
        self.wqkv = nn.Linear(D, qkv_out, bias=cfg.bias or cfg.qkv_bias)
        self.wo = nn.Linear(cfg.num_attention_heads * cfg.head_dim, D,
                            bias=cfg.bias)
        self.w1 = nn.Linear(D, I, bias=False)
        self.w3 = nn.Linear(D, I, bias=False)
        self.w2 = nn.Linear(I, D, bias=False)


class InternLM2Model(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            LLMLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = nn.Parameter(torch.ones(cfg.hidden_size))
        self.output = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


def split_wqkv(qkv: torch.Tensor, cfg: LLMConfig):
    """(B, S, Hkv*(2+G)*hd) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd): per kv head,
    G query slots, then k, then v."""
    B, S, _ = qkv.shape
    G = cfg.num_key_value_groups
    qkv = qkv.reshape(B, S, cfg.num_key_value_heads, 2 + G, cfg.head_dim)
    q = qkv[:, :, :, :G].reshape(B, S, cfg.num_attention_heads, cfg.head_dim)
    return q, qkv[:, :, :, -2], qkv[:, :, :, -1]


def head_logits(x: torch.Tensor, output_weight: torch.Tensor) -> torch.Tensor:
    """fp32 vocab logits: the products of the (bf16) operands accumulated
    in fp32, with no rounding of the result to the input dtype."""
    return F.linear(x.float(), output_weight.float())


def attention_forward(p: LLMLayer, cfg: LLMConfig, x: torch.Tensor,
                      cos: torch.Tensor, sin: torch.Tensor, *,
                      segment_ids: Optional[torch.Tensor],
                      positions: Optional[torch.Tensor],
                      kv_cache_layer: Optional[tuple] = None,
                      cache_length: int = 0,
                      kv_valid: Optional[torch.Tensor] = None,
                      rope_pack: Optional[tuple] = None,
                      paged: Optional[PagedStep] = None) -> torch.Tensor:
    """One attention block. kv_cache_layer = (k_buf, v_buf), each
    (B, max_len, Hkv, hd) views into the cache, written in place at
    [cache_length, cache_length + S); kv_valid (B, max_len) masks slots of
    right-padded prompts. ``paged``: attend through the paged cache and
    write this step's k/v into its pool."""
    B, S, _ = x.shape
    fused_rope = rope_pack is not None and kv_cache_layer is None \
        and paged is None
    q, k, v = split_wqkv(p.wqkv(x), cfg)
    if not fused_rope:
        q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)

    if paged is not None:
        out = _paged_attention(paged, q, k, v, segment_ids, positions)
    elif kv_cache_layer is not None:
        k_buf, v_buf = kv_cache_layer
        end = cache_length + S
        if S <= 16:
            out = _two_part_decode_attention(q, k, v, k_buf, v_buf,
                                             cache_length, kv_valid)
            k_buf[:, cache_length:end] = k
            v_buf[:, cache_length:end] = v
        else:
            k_buf[:, cache_length:end] = k
            v_buf[:, cache_length:end] = v
            max_len = k_buf.shape[1]
            kv_pos = torch.arange(max_len, dtype=torch.int32,
                                  device=x.device).expand(B, max_len)
            kv_seg = kv_valid.to(torch.int32) if kv_valid is not None else \
                (kv_pos < end).to(torch.int32)
            q_pos = cache_length + torch.arange(
                S, dtype=torch.int32, device=x.device).expand(B, S)
            out = flash_attention(
                q, k_buf, v_buf,
                q_segment_ids=torch.ones((B, S), dtype=torch.int32,
                                         device=x.device),
                kv_segment_ids=kv_seg, q_positions=q_pos,
                kv_positions=kv_pos, causal=True)
    else:
        out = flash_attention(
            q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            q_positions=positions, kv_positions=positions, causal=True,
            rope_positions=(rope_pack[0], None, rope_pack[1])
            if fused_rope else None)
    return p.wo(out.reshape(B, S, cfg.num_attention_heads * cfg.head_dim))


def _paged_attention(paged: PagedStep, q, k, v, segment_ids, positions):
    cache, li = paged.cache, paged.layer
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    pool = (cache.k_pages, cache.v_pages)
    tables = (cache.page_table, cache.lengths, li)
    scales = dict(k_scales=cache.k_scales, v_scales=cache.v_scales)
    read = dict(scales, slot_base=paged.slot_base)
    S = q.shape[1]
    if S == 1:  # store, then attend with the fresh slot in the pages
        pa.store_fresh_token(k, v, *pool, *tables, **scales)
        return pa.paged_decode_attention(q, None, None, *pool, *tables,
                                         fresh_in_pages=True, **read)
    if S <= 16:
        out = pa.paged_decode_attention(q, k, v, *pool, *tables, **read)
    elif paged.attend_cache:
        out1, lse1 = flash_attention_with_lse(
            q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            causal=True)
        out2, lse2 = pa.paged_prefill_attention(q, *pool, *tables, **read)
        out = pa.merge_lse(out1, lse1, out2, lse2)
    else:  # prefill into empty pages: the prompt attends only to itself
        out = flash_attention(
            q, k, v, q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
            q_positions=positions, kv_positions=positions, causal=True)
    paged_kv.scatter_layers(cache, slice(li, li + 1), k[None], v[None],
                            paged.slots)
    return out


def _two_part_decode_attention(q, k_new, v_new, k_buf, v_buf,
                               cache_length: int,
                               kv_valid: Optional[torch.Tensor]):
    """Decode attention over [cache slots < cache_length | fresh tokens]
    with one fp32 softmax, GQA by grouped einsums. q/k_new/v_new
    (B, S<=16, H*, hd); k_buf/v_buf (B, max_len, Hkv, hd) are only read."""
    B, S, Hq, hd = q.shape
    Hkv = k_buf.shape[2]
    G = Hq // Hkv
    # scaled q is rounded to its dtype first, as in the JAX reference
    qg = (q.float() * hd ** -0.5).to(q.dtype).float().reshape(B, S, Hkv, G,
                                                             hd)
    # slots past cache_length are masked anyway: read only the filled ones
    k_old = k_buf[:, :cache_length].float()
    v_old = v_buf[:, :cache_length]
    s_old = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_old)
    if kv_valid is not None:
        valid = kv_valid[:, :cache_length]
        s_old = torch.where(valid[:, None, None, None, :], s_old, -1e30)
    s_new = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_new.float())
    tri = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s_new = torch.where(tri, s_new, -1e30)
    w = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    w_old, w_new = w[..., :cache_length], w[..., cache_length:]
    out = torch.einsum("bhgqk,bkhd->bqhgd", w_old.to(v_old.dtype).float(),
                       v_old.float())
    out = out + torch.einsum("bhgqk,bkhd->bqhgd",
                             w_new.to(v_new.dtype).float(), v_new.float())
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def mlp_forward(p: LLMLayer, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: w2(silu(w1 x) * w3 x)."""
    return p.w2(F.silu(p.w1(x)) * p.w3(x))


def _mlp_block(p: LLMLayer, cfg: LLMConfig, x: torch.Tensor) -> torch.Tensor:
    return x + mlp_forward(p, rms_norm(x, p.ffn_norm, cfg.rms_norm_eps))


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def layer_forward(p: LLMLayer, cfg: LLMConfig, x, cos, sin, *, segment_ids,
                  positions, kv_cache_layer=None, cache_length: int = 0,
                  kv_valid=None, rope_pack=None, paged=None,
                  mlp_remat: bool = False) -> torch.Tensor:
    """One decoder layer. ``mlp_remat`` (remat='attn_saved'): only the
    SwiGLU block is checkpointed."""
    h = rms_norm(x, p.attention_norm, cfg.rms_norm_eps)
    x = x + attention_forward(
        p, cfg, h, cos, sin, segment_ids=segment_ids, positions=positions,
        kv_cache_layer=kv_cache_layer, cache_length=cache_length,
        kv_valid=kv_valid, rope_pack=rope_pack, paged=paged)
    if mlp_remat:
        return _checkpoint(_mlp_block, p, cfg, x)
    return _mlp_block(p, cfg, x)


def _train_layers(layers, cfg: LLMConfig, x, cos, sin, remat, **kw):
    """The no-cache layer stack under a remat mode (True = 'full', False or
    None = 'none', 'block2', 'block4', 'attn_saved')."""
    mode = {True: "full", False: "none", None: "none"}.get(remat, remat)
    if mode not in ("full", "none", "attn_saved", "block2", "block4"):
        raise ValueError(f"unknown remat mode {remat!r}")
    if not torch.is_grad_enabled():
        mode = "none"  # nothing to rematerialize without a backward

    def run_layer(layer, x):
        return layer_forward(layer, cfg, x, cos, sin,
                             mlp_remat=mode == "attn_saved", **kw)

    def run_block(x, *block):
        for layer in block:
            x = run_layer(layer, x)
        return x

    L = len(layers)
    blk = int(mode[5:]) if mode.startswith("block") else 1
    if blk > 1 and L % blk == 0:
        for i in range(0, L, blk):
            x = _checkpoint(run_block, x, *layers[i:i + blk])
        return x
    # 'full', and a block mode whose block does not divide the depth (the
    # JAX code's fallback to per-layer remat, kept as it is)
    per_layer = mode == "full" or blk > 1
    for layer in layers:
        x = _checkpoint(run_layer, layer, x) if per_layer \
            else run_layer(layer, x)
    return x


def llm_forward(model: InternLM2Model, cfg: LLMConfig, *,
                input_ids: Optional[torch.Tensor] = None,
                inputs_embeds: Optional[torch.Tensor] = None,
                rope_pos_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[KVCache] = None,
                kv_valid: Optional[torch.Tensor] = None,
                paged_cache: Optional[paged_kv.PagedKVCache] = None,
                paged_attend_cache: bool = False,
                remat=False,
                return_hidden: bool = False):
    """Returns (fp32 logits (B, S, V) or the final hidden states, the cache
    advanced by S when a dense one was passed, or the paged cache with its
    pool written and its lengths NOT advanced).

    rope_pos_ids (B, S) float32 are the V2PE ids (default: arange after the
    cache); positions (B, S) int32 order tokens for causality and
    segment_ids (B, S) separate packed sequences (no-cache path) or mark
    right-padding (0) of a paged prompt. paged_attend_cache: a chunk of
    more than 16 tokens also attends over the cached pages (chunked
    prefill). remat: the training remat mode of the no-cache path (see the
    module docstring)."""
    if inputs_embeds is None:
        inputs_embeds = model.tok_embeddings(input_ids)
    x = inputs_embeds
    B, S, _ = x.shape
    base = 0 if kv_cache is None else kv_cache.length
    ar = torch.arange(S, dtype=torch.float32, device=x.device)
    if rope_pos_ids is None:
        rope_pos_ids = (paged_cache.lengths[:, None].float() + ar[None]) \
            if paged_cache is not None else (base + ar).expand(B, S)
    seq_len = base + S
    if paged_cache is not None:
        # the total context matters to dynamic NTK only: read it back then
        seq_len = int(paged_cache.lengths.max()) + S \
            if cfg.rope_mode == "dynamic" else None
    scaled_pos, theta = scale_positions(
        rope_pos_ids.float(), cfg.head_dim, cfg.rope_theta,
        mode=cfg.rope_mode, scaling_factor=cfg.rope_scaling_factor,
        max_position_embeddings=cfg.max_position_embeddings,
        seq_len=seq_len)
    cos, sin = compute_rope_cos_sin(scaled_pos, cfg.head_dim, theta)
    # the kernel's fused rotary takes a fixed theta (dynamic NTK gives a
    # tensor, which keeps the rotary outside)
    rope_pack = (scaled_pos, float(theta)) \
        if isinstance(theta, (int, float)) else None

    slots = slot_base = None
    if paged_cache is not None:
        slot_base = pa.default_slot_base(paged_cache.page_table,
                                         paged_cache.page_size)
        if S > 1:
            slots = paged_kv.token_slots(
                paged_cache, S,
                None if segment_ids is None else segment_ids != 0)
    if kv_cache is None and paged_cache is None:
        x = _train_layers(model.layers, cfg, x, cos, sin, remat,
                          segment_ids=segment_ids, positions=positions,
                          rope_pack=rope_pack)
    else:
        for li, layer in enumerate(model.layers):
            kv_layer = None if kv_cache is None else (kv_cache.k[li],
                                                     kv_cache.v[li])
            paged = None if paged_cache is None else PagedStep(
                paged_cache, li, slot_base, slots, paged_attend_cache)
            x = layer_forward(layer, cfg, x, cos, sin,
                              segment_ids=segment_ids, positions=positions,
                              kv_cache_layer=kv_layer, cache_length=base,
                              kv_valid=kv_valid, rope_pack=rope_pack,
                              paged=paged)
    new_cache = paged_cache if kv_cache is None else \
        dataclasses.replace(kv_cache, length=base + S)
    x = rms_norm(x, model.norm, cfg.rms_norm_eps)
    if return_hidden:
        return x, new_cache
    return head_logits(x, model.output.weight), new_cache
