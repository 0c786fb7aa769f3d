"""Ulysses sequence parallelism (head-scatter all-to-all), port of
``v2pe_tpu/parallel/ulysses.py``.

Each of the ``n`` ranks holds a sequence shard with all heads; an
all-to-all trades the sequence shard for a head shard, the regular flash
attention runs on full-length sequences with H/n heads per rank, and a
second all-to-all restores the layout. Requires Hq and Hkv divisible by
``n``.

With every shard on one card the two exchanges are permutes of the global
tensor. They stay two named functions, the one place a transport between
cards goes: the stacked ``(n, B, S, H/n, D)`` layout between them is what
each rank would hold after the exchange."""

from __future__ import annotations

from typing import Optional

import torch

from v2pe_tpu_torch.ops.attention import _Flash
from v2pe_tpu_torch.parallel.ring import _i32


def _all_to_all_seq_to_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """Global (B, S, H, D), rank r holding rows [r S/n, (r+1) S/n) of all
    heads -> (n, B, S, H/n, D): rank r holding heads [r H/n, (r+1) H/n) of
    the whole sequence."""
    B, S, H, D = x.shape
    return x.reshape(B, S, n, H // n, D).permute(2, 0, 1, 3, 4)


def _all_to_all_heads_to_seq(x: torch.Tensor) -> torch.Tensor:
    """(n, B, S, H/n, D) per-rank head shards -> global (B, S, H, D), whose
    contiguous sequence shards are the ranks'."""
    n, B, S, Hn, D = x.shape
    return x.permute(1, 2, 0, 3, 4).reshape(B, S, n * Hn, D)


def ulysses_flash_attention(n: int, causal: bool, scale: float, q, k, v,
                            seg_q, seg_k, pos_q, pos_k) -> torch.Tensor:
    """Ulysses attention over ``n`` shards of the global tensors: q
    (B, S, Hq, D), k/v (B, S, Hkv, D), ids (B, S) int32 (every rank sees
    the full-length ids: the all-gather of the JAX version is the global
    tensor itself)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if Hq % n or Hkv % n:
        raise ValueError(f"ulysses needs heads divisible by the axis size "
                         f"({Hq}/{Hkv} vs {n})")
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
                      causal: bool = True, scale: Optional[float] = None
                      ) -> torch.Tensor:
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return ulysses_flash_attention(
        seq_shards, causal, float(scale), q, k, v, _i32(q_segment_ids),
        _i32(kv_segment_ids), _i32(q_positions), _i32(kv_positions))
