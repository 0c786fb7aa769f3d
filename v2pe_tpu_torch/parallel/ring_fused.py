"""Fused ring attention: every hop of the ring in one kernel launch. Port
of ``v2pe_tpu/parallel/ring_fused.py``.

The scan ring (``parallel/ring.py``) makes one flash call per (hop, rank)
pair and round-trips the fp32 (out, lse) merge state through device memory
on every hop. The fused forward is one launch of ``csrc/ring_fused_fwd.cu``
for all ranks on the card: a thread block owns one query tile of one rank
and sweeps the K/V chunks of all ``n`` ranks in hop order (hop ``s`` is the
chunk of rank ``me - s``, the scan ring's order), with the online-softmax
state on chip for the whole sweep; ``out`` and ``lse`` are written once.
Dead tiles (half of all under a causal zigzag layout) are skipped from the
min/max of their segment ids and positions, finer than the scan ring's
half-chunk branches, so the forward needs no schedule and reads nothing
back from the card.

The kernel reaches the chunks through a table of ``n`` base pointers per
operand, built on the device; in bf16 its TMA loads of k and v go through a
tensor map of each chunk, encoded on the host from the same addresses (so
at most 8 ranks in bf16). With every shard on one card the addresses point
into the global k, v, segment-id and position tensors; what a ring over
several cards changes is which addresses are written. Across processes the
context refuses the fused mode (``parallel/context.py``; ROADMAP Queue 2,
"#11 across cards"): the scan ring runs there.

The backward is the scan ring's second pass (the lse contract is the same),
so ``fused_ring_attention`` is a drop-in forward upgrade of
``ring_attention``. q and k arrive rotated: this kernel fuses no rotary.

:func:`fused_ring_fwd` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from v2pe_tpu_torch.ops.flash_fwd import (DTYPES, _ptr,
                                          flash_attention_fwd_torch)
from v2pe_tpu_torch.parallel import ring as _ring
from v2pe_tpu_torch.parallel.ring import RingStatics

HEAD_DIMS = (16, 32, 64, 128)
MAX_BF16_RANKS = 8  # csrc/ring_fused_fwd.cu MAX_TC_RANKS

# Kernel launches since the last reset: the smoke run zeroes it, drives a
# sequence-parallel path, and reads how often that path went through the
# kernel.
LAUNCHES = 0


def fused_ring_fwd_torch(n: int, q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                         causal: bool, scale: float):
    """Plain PyTorch version of the kernel: per rank, the ``n`` chunks
    gathered in hop order and the flash forward's plain twin over them.
    Returns (out (B, S, Hq, D) in q's dtype, lse (B, Hq, S) fp32)."""
    _ring._check_ring(n, q, k)
    shard_len = q.shape[1] // n
    chunks = [slice(c * shard_len, (c + 1) * shard_len) for c in range(n)]
    outs, lses = [], []
    for r in range(n):
        order = [chunks[(r - s) % n] for s in range(n)]
        gather = lambda x: torch.cat([x[:, c] for c in order], dim=1)
        out, lse = flash_attention_fwd_torch(
            q[:, chunks[r]], gather(k), gather(v), seg_q[:, chunks[r]],
            gather(seg_k), pos_q[:, chunks[r]], gather(pos_k), causal=causal,
            scale=scale)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _check(n: int, q, k, v, seg_q, seg_k, pos_q, pos_k):
    _ring._check_ring(n, q, k)
    B, S, Hq, D = q.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"fused ring kernel takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"fused ring kernel takes head dim {HEAD_DIMS}, "
                         f"got {D}")
    if q.dtype == torch.bfloat16 and n > MAX_BF16_RANKS:
        raise ValueError(f"fused ring kernel takes at most {MAX_BF16_RANKS} "
                         f"ranks in bf16 (a tensor map of each chunk is a "
                         f"kernel parameter), got {n}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2] != 0:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"for q {tuple(q.shape)}")
    for t in (seg_q, seg_k, pos_q, pos_k):
        if t.shape != (B, S) or t.dtype != torch.int32:
            raise ValueError(f"expected a ({B}, {S}) int32 vector, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (q, k, v, seg_q, seg_k, pos_q, pos_k):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("fused ring kernel takes contiguous tensors")


def chunk_pointer_table(n: int, k, v, seg_k, pos_k) -> torch.Tensor:
    """(4, n) int64 on the device: the address of every rank's chunk of k,
    v, the segment ids and the positions, computed there (no copy from the
    host). The chunks are the contiguous shards of the global tensors."""
    shard_len = k.shape[1] // n
    ranks = torch.arange(n, dtype=torch.int64, device=k.device)
    return torch.stack([
        t.data_ptr() + ranks * (shard_len * t[0, 0].numel()
                                * t.element_size())
        for t in (k, v, seg_k, pos_k)])


def fused_ring_fwd(n: int, q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                   causal: bool, scale: float):
    """The ring forward of all ``n`` ranks: q (B, S, Hq, D), k/v
    (B, S, Hkv, D), ids (B, S) int32, rank r holding rows
    [r S/n, (r + 1) S/n). Returns (out, lse (B, Hq, S) fp32) with the flash
    contract.

    CPU tensors go to the plain version; CUDA tensors go to the kernel,
    after a check that raises on what the kernel does not take."""
    global LAUNCHES
    if q.device.type == "cpu":
        return fused_ring_fwd_torch(n, q, k, v, seg_q, seg_k, pos_q, pos_k,
                                    causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no fused ring kernel for device {q.device}")
    _check(n, q, k, v, seg_q, seg_k, pos_q, pos_k)
    from v2pe_tpu_torch.ops import _build

    lib = _build.load()
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    # referenced until the function returns; the launch is ordered before
    # any reuse of its memory on this stream
    table = chunk_pointer_table(n, k, v, seg_k, pos_k)
    # the same k and v chunk addresses on the host, for the bf16 tile's
    # tensor maps
    k_chunks, v_chunks = ((ctypes.c_longlong * n)(*(
        t.data_ptr() + r * (S // n) * t[0, 0].numel() * t.element_size()
        for r in range(n))) for t in (k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.v2pe_ring_fused_fwd(
        _ptr(q), _ptr(seg_q), _ptr(pos_q), _ptr(table), k_chunks, v_chunks,
        _ptr(out), _ptr(lse), B, n, S // n, Hq, Hkv, D, S * Hkv * D, S,
        int(q.dtype == torch.bfloat16), int(causal), float(scale),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ring_fused_fwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out, lse


class _FusedRingFlash(torch.autograd.Function):
    """Counterpart of ``fused_ring_flash_attention``'s custom_vjp: the
    fused forward, the scan ring's backward."""

    @staticmethod
    def forward(ctx, n, statics, q, k, v, seg_q, seg_k, pos_q, pos_k):
        out, lse = fused_ring_fwd(n, q, k, v, seg_q, seg_k, pos_q, pos_k,
                                  causal=statics.causal, scale=statics.scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse)
        ctx.ring = (n, statics)
        return out

    @staticmethod
    def backward(ctx, do):
        n, statics = ctx.ring
        return (None, None) + _ring._ring_bwd(
            n, statics, ctx.saved_tensors, do) + (None,) * 4


def fused_ring_flash_attention(n: int, statics: RingStatics, q, k, v, seg_q,
                               seg_k, pos_q, pos_k) -> torch.Tensor:
    """Differentiable fused ring attention over ``n`` shards of the global
    tensors (the contract of ``ring.ring_flash_attention``)."""
    return _FusedRingFlash.apply(n, statics, q.contiguous(), k.contiguous(),
                                 v.contiguous(), seg_q.contiguous(),
                                 seg_k.contiguous(), pos_q.contiguous(),
                                 pos_k.contiguous())


def fused_ring_attention(q, k, v, *, seq_shards: int, q_segment_ids,
                         kv_segment_ids, q_positions, kv_positions,
                         causal: bool = True, scale: Optional[float] = None,
                         block_q: int = _ring.FLASH_BLOCK_Q) -> torch.Tensor:
    """Public entry: the contract of :func:`ring.ring_attention`; the
    forward is one kernel launch, the backward the scan ring's (``block_q``
    is its half-chunk threshold). q and k arrive rotated."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    statics = RingStatics(causal=causal, scale=float(scale), block_q=block_q)
    i32 = _ring._i32
    return fused_ring_flash_attention(
        seq_shards, statics, q, k, v, i32(q_segment_ids),
        i32(kv_segment_ids), i32(q_positions), i32(kv_positions))
