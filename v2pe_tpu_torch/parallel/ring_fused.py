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
into the global k, v, segment-id and position tensors, and one launch
serves every rank.

Across processes (the ``seq`` axis of a mesh, one rank a process) each rank
launches the kernel once, for its own queries (:func:`dist_fused_ring_fwd`):
the table and the maps hold each rank's chunk as mapped in the calling
process. Every rank keeps one buffer for its chunk's k, v, segment ids and
positions (:class:`_PeerChunks`), allocated for the largest chunk so far;
its CUDA IPC handle is exchanged over the group once, and the peers' buffers
are opened once (IPC maps the caching allocator's whole block: the rebuilt
storage carries the buffer's offset inside it). A call copies the rank's
chunk in, synchronizes, meets the peers at a barrier, launches, synchronizes
and meets them again before any buffer is written anew. Every rank runs the
same launches in the same order (a checkpointed forward recomputes them in
the backward's order on every rank alike), so the barriers pair up. On the
CPU the plain version all-gathers the chunks over the group instead and
runs :func:`fused_ring_fwd_torch`'s sweep for the rank's rows.

The backward is the scan ring's second pass (the lse contract is the same;
across processes its P2P form, ``ring._dist_ring_bwd``), so
``fused_ring_attention`` is a drop-in forward upgrade of
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

HEAD_DIMS = (16, 32, 64, 96, 128)
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
    outs, lses = [], []
    for r in range(n):
        mine = slice(r * shard_len, (r + 1) * shard_len)
        out, lse = _rank_sweep_torch(n, r, q[:, mine], k, v, seg_q[:, mine],
                                     seg_k, pos_q[:, mine], pos_k,
                                     causal=causal, scale=scale)
        outs.append(out)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _rank_sweep_torch(n: int, r: int, q, k, v, seg_q, seg_k, pos_q, pos_k,
                      *, causal: bool, scale: float):
    """Rank r's queries (B, S/n, ...) against the global k/v and ids
    (B, S, ...), the chunks gathered in rank r's hop order."""
    shard_len = k.shape[1] // n
    chunks = [slice(c * shard_len, (c + 1) * shard_len) for c in range(n)]
    order = [chunks[(r - s) % n] for s in range(n)]
    gather = lambda x: torch.cat([x[:, c] for c in order], dim=1)  # noqa
    return flash_attention_fwd_torch(q, gather(k), gather(v), seg_q,
                                     gather(seg_k), pos_q, gather(pos_k),
                                     causal=causal, scale=scale)


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
        int(q.dtype == torch.bfloat16), int(causal), float(scale), 0, n,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ring_fused_fwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out, lse


# --------------------------------------------------------------------------
# Across processes
# --------------------------------------------------------------------------

# Seconds of the last cross-process call's host side, by part ("copy": the
# chunk into the rank's buffer and the synchronize after it, "barriers":
# the two meetings of the peers, "launch": the launch and the synchronize
# after it): the smoke run logs them beside the kernel's time.
DIST_SECONDS: dict = {}

_ALIGN = 256  # bytes: each operand's place in a rank's buffer


class _PeerChunks:
    """Each rank's chunk buffer on the card and the peers' as mapped in
    this process, for one group: one uint8 buffer a rank holding k, v, the
    segment ids and the positions at fixed offsets, sized for the largest
    chunk so far (a larger chunk allocates anew and exchanges again, on
    every rank alike)."""

    _by_group: dict = {}

    def __init__(self, group, nbytes: int, device):
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor

        self.nbytes = nbytes
        self.mine = torch.empty(nbytes, dtype=torch.uint8, device=device)
        handles = [None] * dist.get_world_size(group)
        dist.all_gather_object(handles, reduce_tensor(self.mine),
                               group=group)
        me = dist.get_rank(group)
        self.ranks = [self.mine if r == me else fn(*args)
                      for r, (fn, args) in enumerate(handles)]
        self._tables = {}

    def table(self, offsets: tuple):
        """The (4, n) chunk pointer table on the card for a layout of the
        operands (built once a layout), and the k and v rows on the
        host."""
        if offsets not in self._tables:
            addr = [[buf.data_ptr() + at for buf in self.ranks]
                    for at in offsets[:4]]
            n = len(self.ranks)
            self._tables[offsets] = (
                torch.tensor(addr, dtype=torch.int64).to(self.mine.device),
                *((ctypes.c_longlong * n)(*a) for a in addr[:2]))
        return self._tables[offsets]

    @classmethod
    def get(cls, group, nbytes: int, device) -> "_PeerChunks":
        from v2pe_tpu_torch.parallel import bootstrap

        held = cls._by_group.get(group)
        if held is None or held.nbytes < nbytes:
            if not cls._by_group:  # dropped before the group is left
                bootstrap._RELEASE.append(cls._by_group.clear)
            held = cls._by_group[group] = cls(group, nbytes, device)
        return held


def _layout(*tensors) -> list:
    """The byte offset of each operand in a rank's buffer, and the end."""
    at, out = 0, []
    for t in tensors:
        out.append(at)
        at += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    return out + [at]


def dist_fused_ring_fwd(group, q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                        causal: bool, scale: float):
    """The fused ring forward of this rank's queries across the ranks of
    ``group``, each holding its own shard: q (B, S/n, Hq, D), k/v
    (B, S/n, Hkv, D), ids (B, S/n) int32 with global positions. Returns
    (out, lse (B, Hq, S/n) fp32), rank r's rows of the one-process form.

    CPU tensors: the chunks all-gathered and the plain sweep. CUDA tensors:
    one kernel launch over the peers' chunks, mapped by CUDA IPC."""
    import time

    import torch.distributed as dist

    n, r = dist.get_world_size(group), dist.get_rank(group)
    if q.device.type == "cpu":
        def gather(t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim=1)

        return _rank_sweep_torch(n, r, q, gather(k), gather(v), seg_q,
                                 gather(seg_k), pos_q, gather(pos_k),
                                 causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no fused ring kernel for device {q.device}")
    _check(1, q, k, v, seg_q, seg_k, pos_q, pos_k)
    if q.dtype == torch.bfloat16 and n > MAX_BF16_RANKS:
        raise ValueError(f"fused ring kernel takes at most {MAX_BF16_RANKS} "
                         f"ranks in bf16, got {n}")
    chunk = (k, v, seg_k, pos_k)
    offsets = _layout(*chunk)
    t0 = time.perf_counter()
    mine = _PeerChunks.get(group, offsets[-1], q.device).mine
    for t, at in zip(chunk, offsets):
        nb = t.numel() * t.element_size()
        mine[at:at + nb].copy_(t.contiguous().view(-1).view(torch.uint8))
    torch.cuda.synchronize(q.device)
    t1 = time.perf_counter()
    dist.barrier(group=group)  # every rank's chunk is in its buffer
    t2 = time.perf_counter()
    out, lse = rank_launch(group, q, seg_q, pos_q, chunk, causal=causal,
                           scale=scale)
    torch.cuda.synchronize(q.device)
    t3 = time.perf_counter()
    dist.barrier(group=group)  # no peer reads a buffer any more
    DIST_SECONDS.update(copy=t1 - t0, barriers=t2 - t1 + time.perf_counter()
                        - t3, launch=t3 - t2)
    return out, lse


def rank_launch(group, q, seg_q, pos_q, chunk, *, causal: bool,
                scale: float):
    """One launch of the kernel for this rank's queries over the chunks
    that the ranks' buffers hold now (``chunk``: this rank's (k, v, seg_k,
    pos_k), which give the buffers' layout). No copy and no barrier: the
    caller has put the chunks in place (:func:`dist_fused_ring_fwd`)."""
    import torch.distributed as dist

    global LAUNCHES
    from v2pe_tpu_torch.ops import _build

    lib = _build.load()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, Sl, Hq, D = q.shape
    Hkv = chunk[0].shape[2]
    offsets = tuple(_layout(*chunk))
    table, k_chunks, v_chunks = _PeerChunks.get(
        group, offsets[-1], q.device).table(offsets)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sl), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.v2pe_ring_fused_fwd(
        _ptr(q), _ptr(seg_q), _ptr(pos_q), _ptr(table), k_chunks, v_chunks,
        _ptr(out), _ptr(lse), B, n, Sl, Hq, Hkv, D, Sl * Hkv * D, Sl,
        int(q.dtype == torch.bfloat16), int(causal), float(scale), r, 1,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ring_fused_fwd kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out, lse


class _DistFusedRingFlash(torch.autograd.Function):
    """The fused forward across processes, the scan ring's P2P backward
    (JAX's ``defvjp(_fused_fwd, _ring._ring_bwd)``)."""

    @staticmethod
    def forward(ctx, group, statics, q, k, v, seg_q, seg_k, pos_q, pos_k):
        schedule = _ring.dist_ring_schedule(statics, group, seg_q, seg_k,
                                            pos_q, pos_k)
        out, lse = dist_fused_ring_fwd(group, q, k, v, seg_q, seg_k, pos_q,
                                       pos_k, causal=statics.causal,
                                       scale=statics.scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse)
        ctx.ring = (group, statics, schedule)
        return out

    @staticmethod
    def backward(ctx, do):
        group, statics, schedule = ctx.ring
        return (None, None) + _ring._dist_ring_bwd(
            group, statics, ctx.saved_tensors, do, schedule) + (None,) * 4


def dist_fused_ring_flash_attention(group, statics: RingStatics, q, k, v,
                                    seg_q, seg_k, pos_q, pos_k
                                    ) -> torch.Tensor:
    """Differentiable fused ring attention over the ranks of ``group``
    (the contract of ``ring.dist_ring_flash_attention``)."""
    return _DistFusedRingFlash.apply(group, statics, q.contiguous(),
                                     k.contiguous(), v.contiguous(),
                                     seg_q.contiguous(), seg_k.contiguous(),
                                     pos_q.contiguous(), pos_k.contiguous())


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
