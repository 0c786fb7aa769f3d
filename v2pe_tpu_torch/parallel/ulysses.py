"""Ulysses sequence parallelism (head-scatter all-to-all), port of
``v2pe_tpu/parallel/ulysses.py``.

Each of the ``n`` ranks holds a sequence shard with all heads; an
all-to-all trades the sequence shard for a head shard, the regular flash
attention runs on full-length sequences with H/n heads per rank, and a
second all-to-all restores the layout. Requires Hq and Hkv divisible by
``n``.

Two transports. With every shard on one card the two exchanges are
permutes of the global tensor: the stacked ``(n, B, S, H/n, D)`` layout
between them is what each rank would hold after the exchange. With one
rank a process (``group`` given) they are ``all_to_all_single`` over the
``seq`` group, the port of JAX's ``jax.lax.all_to_all``, and each rank
holds only its own shard."""

from __future__ import annotations

from typing import Optional

import torch

import torch.distributed as dist

from v2pe_tpu_torch.ops.attention import _Flash
from v2pe_tpu_torch.parallel.ring import _i32


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal blocks along dim 0; its gradient is
    the same exchange of the output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def _all_to_all_seq_to_heads(x: torch.Tensor, n: int,
                             group=None) -> torch.Tensor:
    """One card: global (B, S, H, D), rank r holding rows
    [r S/n, (r+1) S/n) of all heads -> (n, B, S, H/n, D): rank r holding
    heads [r H/n, (r+1) H/n) of the whole sequence. Across ranks: this
    rank's (B, S/n, H, D) -> its (B, S, H/n, D)."""
    if group is None:
        B, S, H, D = x.shape
        return x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4)
    B, Sn, H, D = x.shape
    blocks = x.reshape(B, Sn, n, H // n, D).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(blocks.contiguous(), group)  # block j: rank j's rows
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * Sn, H // n, D)


def _all_to_all_heads_to_seq(x: torch.Tensor, group=None) -> torch.Tensor:
    """One card: (n, B, S, H/n, D) per-rank head shards -> global
    (B, S, H, D), whose contiguous sequence shards are the ranks'. Across
    ranks: this rank's (B, S, H/n, D) -> its (B, S/n, H, D)."""
    if group is None:
        n, B, S, Hn, D = x.shape
        return x.permute(1, 2, 0, 3, 4).reshape(B, S, n * Hn, D)
    n = dist.get_world_size(group)
    B, S, Hn, D = x.shape
    blocks = x.reshape(B, n, S // n, Hn, D).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(blocks.contiguous(), group)  # block j: rank j's heads
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hn, D)


def _gather_seq(t: torch.Tensor, group) -> torch.Tensor:
    """(B, S/n) ids of every rank, concatenated in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def ulysses_flash_attention(n: int, causal: bool, scale: float, q, k, v,
                            seg_q, seg_k, pos_q, pos_k,
                            group=None) -> torch.Tensor:
    """Ulysses attention over ``n`` shards of the global tensors: q
    (B, S, Hq, D), k/v (B, S, Hkv, D), ids (B, S) int32 (every rank sees
    the full-length ids: the all-gather of the JAX version is the global
    tensor itself). With ``group`` (of ``n`` ranks) each rank passes its own
    contiguous shard (B, S/n, ...) and gets its rows of the output."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % n or Hkv % n:
        raise ValueError(f"ulysses needs heads divisible by the axis size "
                         f"({Hq}/{Hkv} vs {n})")
    if group is not None:
        if dist.get_world_size(group) != n:
            raise ValueError(f"a group of {dist.get_world_size(group)} "
                             f"ranks for {n} shards")
        ids = [_gather_seq(t, group) for t in (seg_q, seg_k, pos_q, pos_k)]
        qg, kg, vg = (_all_to_all_seq_to_heads(t, n, group)
                      for t in (q, k, v))
        out = _Flash.apply(qg.contiguous(), kg.contiguous(),
                           vg.contiguous(), *ids, None, None, causal, scale,
                           0.0)
        return _all_to_all_heads_to_seq(out, group)
    qg = _all_to_all_seq_to_heads(q, n)
    kg = _all_to_all_seq_to_heads(k, n)
    vg = _all_to_all_seq_to_heads(v, n)
    ids = [t.contiguous() for t in (seg_q, seg_k, pos_q, pos_k)]
    out = torch.stack([
        _Flash.apply(qg[r].contiguous(), kg[r].contiguous(),
                     vg[r].contiguous(), *ids, None, None, causal, scale,
                     0.0)
        for r in range(n)])
    return _all_to_all_heads_to_seq(out)


def ulysses_attention(q, k, v, *, seq_shards: int, q_segment_ids,
                      kv_segment_ids, q_positions, kv_positions,
                      causal: bool = True, scale: Optional[float] = None,
                      group=None) -> torch.Tensor:
    """Public entry: the global tensors, or with ``group`` this rank's
    shard of them (see :func:`ulysses_flash_attention`)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return ulysses_flash_attention(
        seq_shards, causal, float(scale), q, k, v, _i32(q_segment_ids),
        _i32(kv_segment_ids), _i32(q_positions), _i32(kv_positions),
        group=group)
