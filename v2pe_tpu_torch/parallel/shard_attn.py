"""Routes the model's attention onto the ``seq`` axis (port of
``v2pe_tpu/parallel/shard_attn.py``). Three regimes:

* the mesh's seq axis across processes, causal (the decoder): each rank
  holds its zigzag shard and the ring runs over the ``seq`` group
  (``ring.dist_ring_flash_attention``, the scan ring, or
  ``ring_fused.dist_fused_ring_flash_attention``, one launch a rank over
  the peers' chunks, as the context says);
* ring shards on one card, causal, the sequence divisible: ring attention
  over the ``n`` contiguous shards of the global (zigzag-permuted)
  sequence, scan or fused as the context says;
* otherwise (the ViT's bidirectional tiles, seq = 1): the plain flash call
  on the rank's tiles. The JAX package shards the ViT's tile batch over
  every mesh axis and all-gathers the embeddings; the port shards the tiles
  over (data, fsdp), where the rows go, and every ``seq`` rank of a row
  group runs all of that group's tiles (it needs their embeddings for its
  own image slots, and the sum of the ``seq`` ranks' gradients is the
  whole gradient). Under ``tensor`` each rank attends with its heads.
"""

from __future__ import annotations

from v2pe_tpu_torch.ops.attention import _Flash
from v2pe_tpu_torch.ops.flash_fwd import _apply_rope
from v2pe_tpu_torch.parallel.context import ShardingContext
from v2pe_tpu_torch.parallel.ring import (RingStatics,
                                          dist_ring_flash_attention,
                                          ring_flash_attention)


def sharded_flash_attention(ctx: ShardingContext, causal: bool, scale: float,
                            rope_theta: float, q, k, v, seg_q, seg_k, pos_q,
                            pos_k, rope_q=None, rope_k=None):
    """The attention of ``ops/attention.flash_attention`` under ``ctx``:
    contiguous q/k/v, int32 ids, the rotary ids when ``rope_theta`` is
    set."""
    across = ctx.size("seq")
    n = ctx.seq_shards
    if causal and across > 1:
        if rope_theta:
            q, k = _apply_rope(q, k, rope_q, rope_k, rope_theta)
        if ctx.ring_mode == "fused":
            from v2pe_tpu_torch.parallel.ring_fused import \
                dist_fused_ring_flash_attention as dist_impl
        else:
            dist_impl = dist_ring_flash_attention
        return dist_impl(ctx.group("seq"),
                         RingStatics(causal=causal, scale=scale), q, k, v,
                         seg_q, seg_k, pos_q, pos_k)
    if not (causal and n > 1 and q.shape[1] % n == 0):
        return _Flash.apply(q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q,
                            rope_k, causal, scale, rope_theta)
    if rope_theta:
        # ring: pre-rotate outside the kernel; carrying rope ids with the
        # chunks is not worth it where the quadratic attention dominates
        q, k = _apply_rope(q, k, rope_q, rope_k, rope_theta)
    statics = RingStatics(causal=causal, scale=scale)
    if ctx.ring_mode == "fused":
        from v2pe_tpu_torch.parallel.ring_fused import \
            fused_ring_flash_attention as ring_impl
    else:  # "scan": the context refuses any other mode
        ring_impl = ring_flash_attention
    return ring_impl(n, statics, q, k, v, seg_q, seg_k, pos_q, pos_k)
