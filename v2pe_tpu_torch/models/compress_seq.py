"""Compress-seq: the hierarchical sequence-compression forward of the
reference's experimental long-context trainer (port of
``v2pe_tpu/models/compress_seq.py``).

Per decoder layer, each sequence chunk is average-pooled to ``FINAL_SIZE``
= 100 summary tokens, the summaries of all chunks run through an
``interaction`` self-attention (weights first copied from the layer's own
attention), and each chunk fuses the summaries of EARLIER chunks through a
LayerScale gate at 1e-3 ('add': the sum of every earlier chunk's
summaries; 'cross-attn': cross-attention onto chunk i-1's summaries with
weights cloned from the layer's attention) before its own within-chunk
attention. The chunk axis is an array dimension.

Both attentions of a layer go through ``internlm2.attention_forward`` and
so through ``ops/attention.flash_attention``: the flash kernel forward
(#1) and its backward kernels (#2-#3) on the card. The interaction runs
over ``chunk_num * 100`` summary tokens in one segment, causal, its rotary
applied outside the kernel; the within-chunk attention over the whole
sequence with one segment per (packed sample, chunk). The cross-attention
fuse is plain fp32 torch, as the JAX version computes it in fp32 einsums
outside any kernel. As in the JAX package, ``remat`` does not apply to
this decoder (the ViT keeps it).

On a mesh (``parallel/mesh.py:shard_model``) each decoder layer's part of
the forward runs through the layer's call (``LLMLayer.forward``'s
``body``), so that FSDP2 gathers its weights around it and reduce-scatters
their gradients; the compress parameters sit in the root unit. Over
``tensor`` the interaction attention splits its heads as the layer's own
attention does, and so does the cross-attention fuse (``wq`` and ``wkv``
by heads, ``wo`` by its inputs, one all-reduce after it). A sharded
sequence (``seq`` above 1) is refused: see :func:`_no_sharding`.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from v2pe_tpu_torch.core.config import LLMConfig
from v2pe_tpu_torch.models.internlm2 import (InternLM2Model, _mlp_block,
                                             attention_forward, head_logits)
from v2pe_tpu_torch.ops.norms import rms_norm
from v2pe_tpu_torch.ops.rope import apply_rotary, compute_rope_cos_sin
from v2pe_tpu_torch.parallel import context as parallel_context
from v2pe_tpu_torch.parallel.mesh import column_input, row_output

FINAL_SIZE = 100


class InteractionLayer(nn.Module):
    """One layer's interaction attention: its own ``wqkv`` / ``wo`` (and
    biases), used with the layer's norms."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        qkv_out = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) \
            * cfg.head_dim
        self.wqkv = nn.Linear(cfg.hidden_size, qkv_out,
                              bias=cfg.bias or cfg.qkv_bias)
        self.wo = nn.Linear(cfg.num_attention_heads * cfg.head_dim,
                            cfg.hidden_size, bias=cfg.bias)


class FuseLayer(nn.Module):
    """One layer's cross-attention fuse: ``wq`` and ``wkv`` split from the
    layer's fused ``wqkv``, ``wo`` copied; no biases."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        D, Hd = cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim
        self.wq = nn.Linear(D, Hd, bias=False)
        self.wkv = nn.Linear(D, 2 * cfg.num_key_value_heads * cfg.head_dim,
                             bias=False)
        self.wo = nn.Linear(Hd, D, bias=False)


class Compress(nn.Module):
    """The compress-seq parameters of a decoder: ``layer_scale`` (L, D),
    per-layer ``interaction`` attentions and, for ``fuse_method=
    'cross-attn'``, per-layer ``fuse`` cross-attentions."""

    def __init__(self, cfg: LLMConfig, fuse_method: str = "add"):
        super().__init__()
        L = cfg.num_hidden_layers
        self.layer_scale = nn.Parameter(torch.zeros(L, cfg.hidden_size))
        self.interaction = nn.ModuleList(InteractionLayer(cfg)
                                         for _ in range(L))
        if fuse_method == "cross-attn":
            self.fuse = nn.ModuleList(FuseLayer(cfg) for _ in range(L))
        elif fuse_method != "add":
            raise NotImplementedError(f"fuse_method={fuse_method!r}")


def split_wqkv_for_cross(wqkv: torch.Tensor, cfg: LLMConfig):
    """The fused interleaved ``wqkv`` weight (Hkv*(G+2)*hd, D) -> ``wq``
    (Hq*hd, D) and ``wkv`` (2*Hkv*hd, D): per kv group the first G*hd rows
    are q, the last 2*hd k and v (``reuse_self_attention_params``)."""
    D = wqkv.shape[-1]
    G = cfg.num_key_value_groups
    w = wqkv.reshape(cfg.num_key_value_heads, G + 2, cfg.head_dim, D)
    return (w[:, :G].reshape(cfg.num_attention_heads * cfg.head_dim, D),
            w[:, G:].reshape(cfg.num_key_value_heads * 2 * cfg.head_dim, D))


@torch.no_grad()
def init_compress_params(llm: InternLM2Model, init_value: float = 1e-3,
                         cfg: Optional[LLMConfig] = None,
                         fuse_method: str = "add") -> Compress:
    """The compress-seq parameters of ``llm``: LayerScale gammas at
    ``init_value`` in the model's dtype, interaction attentions copied from
    each layer's attention and, with 'cross-attn', fuse weights split from
    each layer's ``wqkv`` (``cfg`` required) with ``wo`` copied. New
    tensors: nothing is shared with ``llm``."""
    if fuse_method not in ("add", "cross-attn"):
        raise NotImplementedError(f"fuse_method={fuse_method!r}")
    layers = llm.layers
    ref = layers[0].attention_norm
    if fuse_method == "cross-attn":
        if cfg is None:
            raise ValueError("cfg required for the cross-attn fuse split")
        out = Compress(cfg, fuse_method).to(device=ref.device,
                                            dtype=ref.dtype)
    else:  # 'add' needs no cfg: the interactions are the layers' copies
        out = Compress.__new__(Compress)
        nn.Module.__init__(out)
        out.layer_scale = nn.Parameter(torch.empty(
            len(layers), ref.shape[0], device=ref.device, dtype=ref.dtype))
        out.interaction = nn.ModuleList(
            InteractionLayer.__new__(InteractionLayer) for _ in layers)
        for src, inter in zip(layers, out.interaction):
            nn.Module.__init__(inter)
            inter.wqkv, inter.wo = copy.deepcopy(src.wqkv), \
                copy.deepcopy(src.wo)
    out.layer_scale.fill_(init_value)
    for src, inter in zip(layers, out.interaction):
        inter.load_state_dict({k: v for k, v in src.state_dict().items()
                               if k.startswith(("wqkv.", "wo."))})
    if fuse_method == "cross-attn":
        for src, fuse in zip(layers, out.fuse):
            wq, wkv = split_wqkv_for_cross(src.wqkv.weight, cfg)
            fuse.wq.weight.copy_(wq)
            fuse.wkv.weight.copy_(wkv)
            fuse.wo.weight.copy_(src.wo.weight)
    return out


def compress_avg(h: torch.Tensor, final_size: int = FINAL_SIZE
                 ) -> torch.Tensor:
    """(B, N, C) -> (B, final_size, C): the mean over N // final_size
    buckets (the tail past final_size * bucket is dropped)."""
    B, N, C = h.shape
    step = N // final_size
    return h[:, :step * final_size].reshape(B, final_size, step, C).mean(
        dim=2)


def attention_pooling(h: torch.Tensor, query_kernel: torch.Tensor,
                      query_bias: torch.Tensor) -> torch.Tensor:
    """Learned pooling: softmax over the sequence of h W (query_kernel
    (C, final_size), the JAX layout) selects final_size weighted mixtures
    (``AttentionPooling``)."""
    hf = h.float()
    weights = torch.softmax(hf @ query_kernel.float() + query_bias.float(),
                            dim=1)
    return torch.einsum("bni,bnd->bid", weights, hf).to(h.dtype)


def topk_pooling(h: torch.Tensor, query_kernel: torch.Tensor,
                 query_bias: torch.Tensor, final_size: int) -> torch.Tensor:
    """Score tokens with a scalar head (query_kernel (C, 1)), keep the top
    final_size by score, each weighted by its softmaxed score
    (``TopKPooling``). Ties go to the earlier token, as ``lax.top_k``
    breaks them."""
    scores = (h.float() @ query_kernel.float() + query_bias.float())[..., 0]
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :final_size], idx[:, :final_size]
    selected = torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))
    weights = torch.softmax(top, dim=1)[..., None]
    return (selected.float() * weights).to(h.dtype)


def sigmoid_gate(x1: torch.Tensor, x2: torch.Tensor,
                 gate: torch.Tensor) -> torch.Tensor:
    """x1 * sigmoid(g) + x2 * (1 - sigmoid(g)) (the ``Sigmoid`` module)."""
    g = torch.sigmoid(gate)
    return x1 * g + x2 * (1 - g)


def compress2_avg(h: torch.Tensor, pos: torch.Tensor,
                  final_size: int = FINAL_SIZE):
    """(B, N, C), (B, N) -> the bucket means of the states and the bucket
    medians of the positions; for an even bucket the LOWER middle value,
    as ``torch.median`` gives it (taken here by a sort)."""
    B, N, C = h.shape
    final_size = min(final_size, N)
    step = N // final_size
    used = step * final_size
    hc = h[:, :used].reshape(B, final_size, step, C).mean(dim=2)
    ps = torch.sort(pos[:, :used].reshape(B, final_size, step), dim=2).values
    return hc, ps[:, :, (step - 1) // 2]


def cross_attention_fuse(fuse: FuseLayer, cfg: LLMConfig, x_q: torch.Tensor,
                         x_kv: torch.Tensor, pos_q: torch.Tensor,
                         pos_k: torch.Tensor) -> torch.Tensor:
    """Chunk states (queries, (B, Sq, D)) over summary tokens (keys and
    values, (B, Sk, D)): a rotary per side from the float32 ids pos_q /
    pos_k, GQA, an fp32 softmax with no mask, then ``wo``
    (``InternLM2CrossAttention``). Each projection takes the products of
    the operands accumulated in fp32, rounded to x's dtype. Under a
    ``tensor`` split (``parallel/mesh.py``) the fuse holds a rank's query
    and KV heads and ``wo``'s matching inputs; its fp32 partial products
    are summed over the ranks before the rounding."""
    B, Sq, D = x_q.shape
    Sk = x_kv.shape[1]
    hd = cfg.head_dim
    Hq, Hkv = fuse.wq.weight.shape[0] // hd, \
        fuse.wkv.weight.shape[0] // (2 * hd)
    split = Hq != cfg.num_attention_heads
    G = Hq // Hkv
    x_q, x_kv = column_input(x_q, split), column_input(x_kv, split)

    def dot(x, w):
        return F.linear(x.float(), w.float()).to(x.dtype)

    q = dot(x_q, fuse.wq.weight).reshape(B, Sq, Hq, hd)
    kv = dot(x_kv, fuse.wkv.weight).reshape(B, Sk, Hkv, 2, hd)
    k, v = kv[..., 0, :], kv[..., 1, :]
    cos, sin = compute_rope_cos_sin(pos_q.float(), hd, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    cos, sin = compute_rope_cos_sin(pos_k.float(), hd, cfg.rope_theta)
    k = apply_rotary(k, cos, sin)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, G, hd).float(),
                     k.float()) * hd ** -0.5
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    o = o.reshape(B, Sq, Hq * hd).to(x_q.dtype)
    return row_output(F.linear(o.float(), fuse.wo.weight.float()),
                      split).to(x_q.dtype)


def _no_sharding(what: str) -> None:
    """Refuse a sharded sequence. JAX runs its compress step under ``seq``
    as its one-device step on whatever array it is given, and its trainer
    hands it the zigzag-permuted batch of the ring, so its chunks are other
    tokens than at ``seq`` = 1 (ROADMAP Queue 3, "Known faults inside the
    reference"): there is no step of JAX's to hold a split of the chunks
    to.

    Nor under a ``pipe`` axis: JAX's compress forward has its own layer
    loop with no pipeline branch (``v2pe_tpu/models/compress_seq.py``), so
    under ``pipe`` it would gather every stage's layers onto every rank
    (ROADMAP Queue 3, "Known faults inside the reference"); a pipe rank of
    the port holds its stage's layers only."""
    ctx = parallel_context.current()
    if ctx is not None and ctx.pipe_shards > 1:
        raise NotImplementedError(
            f"{what} under a pipe axis (--mesh_pipe > 1): JAX's compress "
            f"layer loop has no pipeline branch and would gather every "
            f"stage's layers (ROADMAP Queue 3, 'Known faults inside the "
            f"reference')")
    if ctx is not None and (ctx.seq_shards > 1 or ctx.size("seq") > 1):
        raise NotImplementedError(
            f"{what} with a sharded sequence (--mesh_seq > 1): JAX's "
            f"trainer chunks the zigzag-permuted batch there (ROADMAP "
            f"Queue 1 item 6.4; Queue 3, 'Known faults inside the "
            f"reference')")


def compress_llm_forward(model: InternLM2Model, compress: Compress,
                         cfg: LLMConfig, inputs_embeds: torch.Tensor,
                         rope_pos_ids: torch.Tensor, n_chunks: int, *,
                         segment_ids: Optional[torch.Tensor] = None,
                         final_size: int = FINAL_SIZE,
                         fuse_method: str = "add",
                         return_hidden: bool = False) -> torch.Tensor:
    """The hierarchical forward: fp32 logits (B, S, V), or the final
    hidden states with ``return_hidden`` (the chunked-CE training path).

    'add': chunk i adds LayerScale(the sum of the interaction-refined
    summaries of chunks j < i). 'cross-attn': chunk i cross-attends onto
    chunk i-1's summaries, LayerScale-gated (chunk 0 adds 0).
    ``segment_ids`` (packing, 0 = padding): a token attends within its
    chunk AND its packed sample, as the reference's per-chunk varlen
    attention does; the within-chunk segment is
    ``seg * n_chunks + chunk + 1`` (0 kept for padding). The summaries
    cross sample boundaries, as the reference's chunk pooling does."""
    _no_sharding("compress-seq")
    B, S, D = inputs_embeds.shape
    if S % n_chunks:
        raise ValueError(f"{S} tokens do not split into {n_chunks} chunks")
    c = S // n_chunks
    # chunks shorter than FINAL_SIZE would leave empty buckets
    final_size = min(final_size, c)
    dev = inputs_embeds.device
    x = inputs_embeds
    cos, sin = compute_rope_cos_sin(rope_pos_ids.float(), cfg.head_dim,
                                    cfg.rope_theta)
    chunk_idx = (torch.arange(S, device=dev) // c).to(torch.int32)[None] \
        .expand(B, S)
    if segment_ids is not None:
        seg = torch.where(segment_ids == 0, 0,
                          segment_ids.to(torch.int32) * n_chunks
                          + chunk_idx + 1).to(torch.int32)
    else:
        seg = chunk_idx + 1
    n_sum = n_chunks * final_size
    sum_pos = torch.arange(n_sum, dtype=torch.float32, device=dev)[None] \
        .expand(B, n_sum)
    cos_i, sin_i = compute_rope_cos_sin(sum_pos, cfg.head_dim, cfg.rope_theta)
    ones = torch.ones((B, n_sum), dtype=torch.int32, device=dev)

    def layer(p, cfg, x, cos, sin, li):
        gamma = compress.layer_scale[li]
        h = rms_norm(x, p.attention_norm, cfg.rms_norm_eps)

        # 1. per-chunk summaries of the normed states
        summ = compress_avg(h.reshape(B * n_chunks, c, D), final_size) \
            .reshape(B, n_sum, D)
        # 2. the interaction self-attention over every chunk's summaries
        summ = attention_forward(compress.interaction[li], cfg, summ, cos_i,
                                 sin_i, segment_ids=ones, positions=None)
        # 3. fuse the earlier chunks' summaries into each chunk
        if fuse_method == "add":
            sums = summ.reshape(B, n_chunks, final_size, D).sum(dim=2)
            prev = torch.cumsum(sums, dim=1) - sums  # exclusive prefix
            h = h + (gamma * prev)[:, :, None, :].expand(
                B, n_chunks, c, D).reshape(B, S, D)
        elif fuse_method == "cross-attn":
            prev = torch.roll(summ.reshape(B, n_chunks, final_size, D), 1,
                              dims=1)  # chunk i-1 (chunk 0: the last)
            kpos = torch.roll(sum_pos.reshape(B, n_chunks, final_size), 1,
                              dims=1)
            fused = cross_attention_fuse(
                compress.fuse[li], cfg, h.reshape(B * n_chunks, c, D),
                prev.reshape(B * n_chunks, final_size, D),
                rope_pos_ids.reshape(B * n_chunks, c),
                kpos.reshape(B * n_chunks, final_size))
            gate = (torch.arange(n_chunks, device=dev) > 0).to(h.dtype)
            fused = fused.reshape(B, n_chunks, c, D) * gate[None, :, None,
                                                            None]
            h = h + (gamma * fused).reshape(B, S, D)
        else:
            raise NotImplementedError(f"fuse_method={fuse_method!r}")

        # 4. the within-chunk attention, then the SwiGLU block
        x = x + attention_forward(p, cfg, h, cos, sin, segment_ids=seg,
                                  positions=None)
        return _mlp_block(p, cfg, x)

    for li, p in enumerate(model.layers):
        x = p(cfg, x, cos, sin, body=layer, li=li)
    x = rms_norm(x, model.norm, cfg.rms_norm_eps)
    return x if return_hidden else head_logits(x, model.output)


def compress_fuse_only_forward(model: InternLM2Model, compress: Compress,
                               cfg: LLMConfig, inputs_embeds: torch.Tensor,
                               rope_pos_ids: torch.Tensor, n_chunks: int, *,
                               final_size: int = FINAL_SIZE,
                               fuse_method: str = "cross-attn"
                               ) -> torch.Tensor:
    """The fuse-only inference branch: no interaction attention; per
    layer, chunk i compresses the normed states of ALL earlier chunks to
    ``final_size`` summaries (``compress2_avg``: bucket means and median
    positions) and fuses them in ('add' or 'cross-attn'), then attends
    within its chunk at its own positions. Returns fp32 logits (B, S, V).

    As in the JAX package, the summaries feed the training fuse (the
    reference computes them and then drops them). A Python loop over
    chunks: the earlier context grows with i."""
    _no_sharding("compress-seq")
    B, S, D = inputs_embeds.shape
    if S % n_chunks:
        raise ValueError(f"{S} tokens do not split into {n_chunks} chunks")
    c = S // n_chunks
    x = inputs_embeds
    cos, sin = compute_rope_cos_sin(rope_pos_ids.float(), cfg.head_dim,
                                    cfg.rope_theta)
    seg = (torch.arange(S, device=x.device) // c + 1).to(torch.int32)[None] \
        .expand(B, S)
    def layer(p, cfg, x, cos, sin, li):
        gamma = compress.layer_scale[li]
        h = rms_norm(x, p.attention_norm, cfg.rms_norm_eps)
        fused = [h[:, :c]]  # chunk 0: no earlier context
        for i in range(1, n_chunks):
            summ, spos = compress2_avg(h[:, :i * c], rope_pos_ids[:, :i * c],
                                       final_size)
            hc = h[:, i * c:(i + 1) * c]
            if fuse_method == "add":
                fused.append(hc + gamma * summ.sum(dim=1, keepdim=True))
            else:
                fused.append(hc + gamma * cross_attention_fuse(
                    compress.fuse[li], cfg, hc, summ,
                    rope_pos_ids[:, i * c:(i + 1) * c], spos))
        h = torch.cat(fused, dim=1)
        x = x + attention_forward(p, cfg, h, cos, sin, segment_ids=seg,
                                  positions=None)
        return _mlp_block(p, cfg, x)

    for li, p in enumerate(model.layers):
        x = p(cfg, x, cos, sin, body=layer, li=li)
    x = rms_norm(x, model.norm, cfg.rms_norm_eps)
    return head_logits(x, model.output)
