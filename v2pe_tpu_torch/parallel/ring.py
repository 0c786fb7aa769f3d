"""Ring attention over the ``seq`` axis (context parallelism), port of
``v2pe_tpu/parallel/ring.py``.

Each of the ``n`` ranks of the ring holds one contiguous shard of the
sequence. At hop ``s`` rank ``r`` attends the K/V chunk of rank ``r - s``.
Each (hop, rank) pair is one call of the flash forward
(``ops/flash_fwd.py``) on the live sub-rectangle, merged into the rank's
online-softmax state through the logsumexp contract. Two transports:

* every shard on one card (:func:`ring_flash_attention`): rank ``r``'s rows
  are ``[r * S/n, (r + 1) * S/n)`` of the global ``(B, S, H, D)`` tensors,
  and the rotation is an index shift;
* one rank a process (:func:`dist_ring_flash_attention`), over a
  ``torch.distributed`` group: each rank holds its shard alone, and each
  hop sends ``(k, v, seg, pos)`` to the next rank by
  ``batch_isend_irecv``, the port of JAX's ``jax.lax.ppermute``; the
  backward sends the chunk's ``(dk, dv)`` accumulators round the ring the
  same way, so they arrive home after the last hop. The ranks all-gather
  their few segment/position statistics once a call, so each rank picks
  the rectangles the one-card ring picks, and every sum runs in the same
  order.

Causality is positional: every token carries its **global** index, so any
host-side shard layout works. :func:`zigzag_shard` is the zigzag
load-balancing layout (rank r takes chunks [r, 2W-1-r] of 2W chunks) and
:func:`zigzag_unshard` its inverse.

The gradient is a second ring pass (:func:`_ring_bwd`): per (hop, rank) pair
the flash backward (``ops/flash_bwd.py``) on the forward's ``out`` and
``lse``, with dq, dk and dv accumulated in fp32.

Which rectangle a (rank, chunk) pair needs depends on the data (segment ids
and positions). :func:`branch_table` decides all ``n x n`` pairs in one
pass of tensor operations on the device and :func:`ring_schedule` reads the
result once: a scan-ring forward costs one read of the card, and its
backward reuses the forward's schedule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from v2pe_tpu_torch.ops.flash_bwd import flash_attention_bwd
from v2pe_tpu_torch.ops.flash_fwd import NEG_INF, flash_attention_fwd
from v2pe_tpu_torch.ops.paged_attention import merge_partials

FLASH_BLOCK_Q = 64  # query rows of the flash kernel's tile


class RingStatics(NamedTuple):
    causal: bool
    scale: float
    # half-chunk rectangles are used when a half shard has at least this
    # many rows (a full query tile of the kernel)
    block_q: int = FLASH_BLOCK_Q


# --------------------------------------------------------------------------
# Zigzag shard layout helpers
# --------------------------------------------------------------------------


def _split(x: torch.Tensor, parts: int, axis: int):
    if x.shape[axis] % parts:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {parts} equal chunks")
    return torch.split(x, x.shape[axis] // parts, dim=axis)


def zigzag_shard(x: torch.Tensor, rank: int, world: int, axis: int = 1):
    """Take chunks [rank, 2*world-1-rank] of 2*world chunks along ``axis``."""
    chunks = _split(x, 2 * world, axis)
    return torch.cat([chunks[rank], chunks[2 * world - 1 - rank]], dim=axis)


def zigzag_unshard(x_gathered: torch.Tensor, world: int, axis: int = 1):
    """Inverse of zigzag_shard applied to the shards of all ranks
    concatenated along ``axis`` (rank-major)."""
    parts = _split(x_gathered, 2 * world, axis)
    return torch.cat(list(parts[0::2]) + list(parts[1::2][::-1]), dim=axis)


def zigzag_global_positions(seq_len_global: int, rank: int, world: int):
    """Global token indices held by ``rank`` under the zigzag layout."""
    idx = np.arange(seq_len_global).reshape(2 * world, -1)
    return np.concatenate([idx[rank], idx[2 * world - 1 - rank]])


# --------------------------------------------------------------------------
# Which rectangle each (rank, chunk) pair needs
# --------------------------------------------------------------------------


def _part_stats(seg: torch.Tensor, pos: torch.Tensor, n: int, parts: int):
    """Per (shard, part of the shard): whether it holds a valid token, the
    largest valid position (else -1) and the smallest (else 2**30), over
    the whole batch, as ``_chunk_has_work`` reduces them."""
    B = seg.shape[0]
    seg = seg.reshape(B, n, parts, -1)
    pos = pos.reshape(B, n, parts, -1)
    valid = seg != 0
    return (valid.any(dim=3).any(dim=0),
            torch.where(valid, pos, -1).amax(dim=3).amax(dim=0),
            torch.where(valid, pos, 2 ** 30).amin(dim=3).amin(dim=0))


def _use_halves(statics: RingStatics, shard_len: int) -> bool:
    """Half-chunk skipping needs even halves big enough to feed full kernel
    blocks; the full rectangle is always right."""
    half = shard_len // 2
    return shard_len % 2 == 0 and half % 8 == 0 and half >= statics.block_q


def _branches(statics: RingStatics, parts: int, q_any, q_max, k_any,
              k_min):
    """:func:`branch_table` from the per-(shard, part) statistics."""
    # w[r, q part, c, k part]
    w = q_any[:, :, None, None] & k_any[None, None]
    if statics.causal:
        w = w & (q_max[:, :, None, None] >= k_min[None, None])
    if parts == 1:
        return w[:, 0, :, 0].long()
    w_ll, w_lh, w_hl, w_hh = w[:, 0, :, 0], w[:, 0, :, 1], w[:, 1, :, 0], \
        w[:, 1, :, 1]
    any_w = w_ll | w_hh | w_hl | w_lh
    fits2 = ~(w_lh | w_hh)          # q_full x k_lo covers {ll, hl}
    fits3 = ~(w_ll | w_lh)          # q_hi x k_full covers {hl, hh}
    fits4 = w_hl & ~(w_ll | w_lh | w_hh)
    branch = torch.where(fits3, 3, 1)
    branch = torch.where(fits2, 2, branch)
    branch = torch.where(fits4, 4, branch)
    return torch.where(any_w, branch, 0)


def branch_table(statics: RingStatics, n: int, seg_q, seg_k, pos_q, pos_k):
    """(n, n) int64 on the inputs' device: entry [r, c] is the minimal
    rectangle of work of rank r's queries against rank c's K/V chunk,
    exploiting the zigzag layout's half-chunk structure (each shard's first
    half holds strictly lower global positions than its second half):

      0: nothing live (fully-masked pair)               -> skip
      1: general case                                   -> q_full x k_full
      2: live pairs within {(lo,lo),(hi,lo)}            -> q_full x k_lo
      3: live pairs within {(hi,hi),(hi,lo)}            -> q_hi  x k_full
      4: only the (q_hi, k_lo) cross rectangle live     -> q_hi  x k_lo

    A pair of (half) chunks has work when both hold a valid token and,
    under ``causal``, the largest valid query position reaches the smallest
    valid key position. Right for any layout: a reduced rectangle is chosen
    only when every live quadrant lies inside it. Without half-chunk
    skipping (see :func:`_use_halves`) the entries are 0 or 1. One pass of
    tensor operations for all n x n pairs, nothing read back."""
    parts = 2 if _use_halves(statics, seg_q.shape[1] // n) else 1
    q_any, q_max, _ = _part_stats(seg_q, pos_q, n, parts)
    k_any, _, k_min = _part_stats(seg_k, pos_k, n, parts)
    return _branches(statics, parts, q_any, q_max, k_any, k_min)


def ring_schedule(statics: RingStatics, n: int, seg_q, seg_k, pos_q,
                  pos_k) -> list:
    """:func:`branch_table` as nested lists on the host: the one read of
    the card a ring pass makes."""
    return branch_table(statics, n, seg_q, seg_k, pos_q, pos_k).tolist()


def _rectangle(branch: int, r: int, c: int, shard_len: int):
    """(query rows, key rows) of a branch as slices of the global sequence;
    None for a skipped pair."""
    if branch == 0:
        return None
    half = shard_len // 2
    q_hi, k_lo = branch in (3, 4), branch in (2, 4)
    return (slice(r * shard_len + (half if q_hi else 0), (r + 1) * shard_len),
            slice(c * shard_len, c * shard_len + (half if k_lo else
                                                  shard_len)))


def _rows(x: torch.Tensor, rows: slice, axis: int = 1) -> torch.Tensor:
    """Rows of the sequence axis as a contiguous tensor (a view when the
    batch is 1)."""
    return x[(slice(None),) * axis + (rows,)].contiguous()


def _check_ring(n: int, q, k):
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"sequence lengths {q.shape[1]}/{k.shape[1]} do "
                         f"not split into {n} shards")
    if q.shape[1] != k.shape[1]:
        raise ValueError("ring attention shards queries and keys alike: "
                         f"got {q.shape[1]} and {k.shape[1]} tokens")


# --------------------------------------------------------------------------
# Ring attention
# --------------------------------------------------------------------------


def _ring_fwd_impl(n: int, statics: RingStatics, q, k, v, seg_q, seg_k,
                   pos_q, pos_k, schedule: Optional[list] = None):
    """n hops; per hop and rank one flash forward on the chosen rectangle,
    merged by lse. Returns (out in q's dtype, lse (B, Hq, S) fp32)."""
    _check_ring(n, q, k)
    B, S, Hq, D = q.shape
    shard_len = S // n
    if schedule is None:
        schedule = ring_schedule(statics, n, seg_q, seg_k, pos_q, pos_k)
    out = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hq, S), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for s in range(n):
        for r in range(n):
            c = (r - s) % n  # hop s brings the chunk of rank r - s
            rect = _rectangle(schedule[r][c], r, c, shard_len)
            if rect is None:
                continue
            qr, kr = rect
            o_i, lse_i = flash_attention_fwd(
                _rows(q, qr), _rows(k, kr), _rows(v, kr), _rows(seg_q, qr),
                _rows(seg_k, kr), _rows(pos_q, qr), _rows(pos_k, kr),
                causal=statics.causal, scale=statics.scale)
            out[:, qr], lse[:, :, qr] = merge_partials(
                out[:, qr], lse[:, :, qr], o_i, lse_i)
    return out.to(q.dtype), lse


def _ring_bwd(n: int, statics: RingStatics, res, do,
              schedule: Optional[list] = None):
    """The second ring pass: per hop and rank the flash backward on the
    rectangle the forward took, gradients accumulated in fp32 at the
    rectangle's offsets. ``res`` = (q, k, v, seg_q, seg_k, pos_q, pos_k,
    out, lse) of the forward."""
    q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse = res
    shard_len = q.shape[1] // n
    if schedule is None:
        schedule = ring_schedule(statics, n, seg_q, seg_k, pos_q, pos_k)
    do = do.to(q.dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for s in range(n):
        for r in range(n):
            c = (r - s) % n
            rect = _rectangle(schedule[r][c], r, c, shard_len)
            if rect is None:
                continue
            qr, kr = rect
            dq_i, dk_i, dv_i = flash_attention_bwd(
                _rows(q, qr), _rows(k, kr), _rows(v, kr), _rows(seg_q, qr),
                _rows(seg_k, kr), _rows(pos_q, qr), _rows(pos_k, kr),
                _rows(out, qr), _rows(lse, qr, axis=2), _rows(do, qr),
                causal=statics.causal, scale=statics.scale)
            dq[:, qr] += dq_i
            dk[:, kr] += dk_i
            dv[:, kr] += dv_i
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """Counterpart of ``ring_flash_attention``'s custom_vjp."""

    @staticmethod
    def forward(ctx, n, statics, q, k, v, seg_q, seg_k, pos_q, pos_k):
        schedule = ring_schedule(statics, n, seg_q, seg_k, pos_q, pos_k)
        out, lse = _ring_fwd_impl(n, statics, q, k, v, seg_q, seg_k, pos_q,
                                  pos_k, schedule)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse)
        ctx.ring = (n, statics, schedule)
        return out

    @staticmethod
    def backward(ctx, do):
        n, statics, schedule = ctx.ring
        return (None, None) + _ring_bwd(n, statics, ctx.saved_tensors, do,
                                        schedule) + (None,) * 4


def ring_flash_attention(n: int, statics: RingStatics, q, k, v, seg_q, seg_k,
                         pos_q, pos_k) -> torch.Tensor:
    """Differentiable ring attention over ``n`` shards of the global
    tensors: q (B, S, Hq, D), k/v (B, S, Hkv, D), ids (B, S) int32."""
    return _RingFlash.apply(n, statics, q, k, v, seg_q, seg_k, pos_q, pos_k)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def ring_attention(q, k, v, *, seq_shards: int, q_segment_ids,
                   kv_segment_ids, q_positions, kv_positions,
                   causal: bool = True, scale: Optional[float] = None,
                   block_q: int = FLASH_BLOCK_Q) -> torch.Tensor:
    """Public entry. The arguments are the global tensors, whose
    ``seq_shards`` contiguous shards along the sequence are the ranks'
    (JAX's per-device entry takes one rank's shard inside ``shard_map``);
    positions must be GLOBAL token indices (zigzag or contiguous layouts
    both work)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    statics = RingStatics(causal=causal, scale=float(scale), block_q=block_q)
    return ring_flash_attention(
        seq_shards, statics, q, k, v, _i32(q_segment_ids),
        _i32(kv_segment_ids), _i32(q_positions), _i32(kv_positions))


# --------------------------------------------------------------------------
# The ring across processes
# --------------------------------------------------------------------------


def dist_ring_schedule(statics: RingStatics, group, seg_q, seg_k, pos_q,
                       pos_k) -> list:
    """:func:`ring_schedule` of a ring whose ranks each hold their own shard:
    each rank's (shard, part) statistics are all-gathered over ``group``
    (a few numbers a rank), then every rank builds the same table."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    parts = 2 if _use_halves(statics, seg_q.shape[1]) else 1
    q_any, q_max, _ = _part_stats(seg_q, pos_q, 1, parts)
    k_any, _, k_min = _part_stats(seg_k, pos_k, 1, parts)
    mine = torch.stack([q_any.long(), q_max.long(), k_any.long(),
                        k_min.long()])                      # (4, 1, parts)
    every = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(every, mine, group=group)
    st = torch.cat(every, dim=1)                           # (4, n, parts)
    return _branches(statics, parts, st[0] != 0, st[1], st[2] != 0,
                     st[3]).tolist()


def _send_on(tensors, group, tag: int = 0):
    """Start sending each tensor to the next rank of the ring and receiving
    the previous rank's; returns (the receive buffers, the requests).
    ``tag`` tells the chunks (0) from the backward's accumulators (1)."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group, tag)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, group, tag) for t in recv]
    return recv, dist.batch_isend_irecv(ops)


def _wait(reqs) -> None:
    for req in reqs:
        req.wait()


def _dist_ring_fwd(group, statics: RingStatics, q, k, v, seg_q, seg_k,
                   pos_q, pos_k, schedule: list):
    """n hops over the group; this rank's queries against the chunk the
    hop brings, merged by lse. The next chunk is on its way while a hop
    computes."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    _check_ring(1, q, k)
    B, S, Hq, D = q.shape
    out = torch.zeros((B, S, Hq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hq, S), NEG_INF, dtype=torch.float32,
                     device=q.device)
    chunk = (k, v, seg_k, pos_k)
    for s in range(n):
        c = (r - s) % n  # hop s brings the chunk of rank r - s
        if s < n - 1:
            nxt, reqs = _send_on(chunk, group)
        rect = _rectangle(schedule[r][c], 0, 0, S)
        if rect is not None:
            qr, kr = rect
            kc, vc, sk, pk = chunk
            o_i, lse_i = flash_attention_fwd(
                _rows(q, qr), _rows(kc, kr), _rows(vc, kr), _rows(seg_q, qr),
                _rows(sk, kr), _rows(pos_q, qr), _rows(pk, kr),
                causal=statics.causal, scale=statics.scale)
            out[:, qr], lse[:, :, qr] = merge_partials(
                out[:, qr], lse[:, :, qr], o_i, lse_i)
        if s < n - 1:
            _wait(reqs)
            chunk = tuple(nxt)
    return out.to(q.dtype), lse


def _dist_ring_bwd(group, statics: RingStatics, res, do, schedule: list):
    """The second pass: the chunks go round again with their fp32 (dk, dv)
    accumulators; the hop that holds a chunk adds its share, and after the
    last hop each accumulator is back on its chunk's rank."""
    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse = res
    S = q.shape[1]
    do = do.to(q.dtype)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    chunk = (k, v, seg_k, pos_k)
    for s in range(n):
        c = (r - s) % n
        if s < n - 1:
            nxt, reqs = _send_on(chunk, group)
        rect = _rectangle(schedule[r][c], 0, 0, S)
        if rect is not None:
            qr, kr = rect
            kc, vc, sk, pk = chunk
            dq_i, dk_i, dv_i = flash_attention_bwd(
                _rows(q, qr), _rows(kc, kr), _rows(vc, kr), _rows(seg_q, qr),
                _rows(sk, kr), _rows(pos_q, qr), _rows(pk, kr),
                _rows(out, qr), _rows(lse, qr, axis=2), _rows(do, qr),
                causal=statics.causal, scale=statics.scale)
            dq[:, qr] += dq_i
            dk[:, kr] += dk_i
            dv[:, kr] += dv_i
        (dk, dv), acc_reqs = _send_on((dk, dv), group, tag=1)
        _wait(acc_reqs)
        if s < n - 1:
            _wait(reqs)
            chunk = tuple(nxt)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _DistRingFlash(torch.autograd.Function):
    """The ring across processes; its backward is the second pass."""

    @staticmethod
    def forward(ctx, group, statics, q, k, v, seg_q, seg_k, pos_q, pos_k):
        schedule = dist_ring_schedule(statics, group, seg_q, seg_k, pos_q,
                                      pos_k)
        out, lse = _dist_ring_fwd(group, statics, q, k, v, seg_q, seg_k,
                                  pos_q, pos_k, schedule)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse)
        ctx.ring = (group, statics, schedule)
        return out

    @staticmethod
    def backward(ctx, do):
        group, statics, schedule = ctx.ring
        return (None, None) + _dist_ring_bwd(group, statics,
                                             ctx.saved_tensors, do,
                                             schedule) + (None,) * 4


def dist_ring_flash_attention(group, statics: RingStatics, q, k, v, seg_q,
                              seg_k, pos_q, pos_k) -> torch.Tensor:
    """Differentiable ring attention over the ranks of ``group``, each
    holding its own shard: q (B, S/n, Hq, D), k/v (B, S/n, Hkv, D), ids
    (B, S/n) int32 with GLOBAL positions (the zigzag shard of
    ``collate_rows(seq_shards=n)``, say)."""
    return _DistRingFlash.apply(group, statics, q.contiguous(),
                                k.contiguous(), v.contiguous(),
                                seg_q.contiguous(), seg_k.contiguous(),
                                pos_q.contiguous(), pos_k.contiguous())
