"""Paged-KV attention: the CUDA kernels' wrappers and their plain twins.

Port of ``v2pe_tpu/ops/paged_attention.py``. The pool is the JAX layout,
(L, Hkv, NP, ps, hd) values plus, for an int8 pool, (L, Hkv, NP, 1, ps)
fp32 scales, and every function takes the WHOLE pool and a layer index:
nothing slices or copies the pool per layer.

* :func:`store_fresh_token` writes each row's fresh k/v (quantized for an
  int8 pool) at slot ``lengths % ps`` of its current page, in place.
* :func:`paged_decode_attention` attends T <= 16 fresh queries per row over
  the row's pages: either with the fresh tokens already stored
  (``fresh_in_pages``, fresh token t sees slots <= lengths + t) or with the
  fresh k/v folded in separately (slots < lengths plus fresh u <= t).
* :func:`paged_prefill_attention` attends a chunk over the cached slots
  (< lengths) only and returns (out, lse) for :func:`merge_lse` with the
  chunk's own causal attention.

Page-table entries of -1 are unallocated; ``slot_base`` (B, MP) gives each
entry's first global slot, -1 for a dead entry, which is skipped. int8
pools: the k scale multiplies the score before the softmax, the v scale
multiplies the softmax weight after the sum l was taken, so l stays
unscaled. A row with nothing to attend gives out 0 and lse -1e30.

The kernels are ``csrc/paged_attention.cu`` (built by ``ops/_build.py``).
Each wrapper runs the twin for CPU tensors and the kernel for CUDA tensors,
and never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_FRESH = 16          # fresh tokens a decode call takes
TWIN_BLOCK_Q = 512      # chunk rows per step of the prefill twin

# Kernel launches since the last reset, by kernel: the smoke run zeroes
# them, drives the serving path, and reads how often it went through each.
LAUNCHES = {"paged_store": 0, "paged_decode": 0, "paged_prefill": 0}


def default_slot_base(page_table: torch.Tensor, page_size: int):
    """Entry j of a row starts at global slot j * page_size; -1 entries
    are dead."""
    MP = page_table.shape[1]
    base = torch.arange(MP, dtype=torch.int32,
                        device=page_table.device)[None] * page_size
    return torch.where(page_table >= 0, base, -1).to(torch.int32)


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """Symmetric int8 quantization per vector of the last dim: returns (int8
    values, fp32 scales with the last dim kept as 1). The scale is amax/127,
    or 1 where amax is 0; values round half to even and clip to +-127."""
    if bits != 8:
        raise NotImplementedError("int4 KV needs a nibble-packed pool layout "
                                  "of its own; only int8 is ported")
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not jnp's (nor the store kernel's) exact division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------- twins


def store_fresh_token_torch(k_new, v_new, k_pages, v_pages, page_table,
                            lengths, layer: int, *, k_scales=None,
                            v_scales=None):
    """Plain twin of the store kernel; writes the pool in place."""
    ps = k_pages.shape[3]
    MP = page_table.shape[1]
    slot = torch.clamp(lengths.long() // ps, max=MP - 1)
    page = torch.gather(page_table.long(), 1, slot[:, None])[:, 0]
    off = lengths.long() % ps
    ok = page >= 0  # an unallocated page takes no write
    page, off = page[ok], off[ok]
    kn, vn = k_new[ok, 0], v_new[ok, 0]           # (n, Hkv, hd)
    if k_scales is not None:
        kn, ks = quantize_kv(kn)
        vn, vs = quantize_kv(vn)
        k_scales[layer][:, page, 0, off] = ks[..., 0].t()
        v_scales[layer][:, page, 0, off] = vs[..., 0].t()
    k_pages[layer][:, page, off] = kn.transpose(0, 1).to(k_pages.dtype)
    v_pages[layer][:, page, off] = vn.transpose(0, 1).to(v_pages.dtype)
    if k_scales is not None:
        return k_pages, v_pages, k_scales, v_scales
    return k_pages, v_pages


def _gather_pages(pages, scales, page_table, layer: int):
    """(B, Hkv, MP*ps, hd) fp32 values of each row's pages (page -1 reads
    page 0, masked by the caller) and their (B, Hkv, MP*ps) scales."""
    B, MP = page_table.shape
    Hkv, _, ps, hd = pages.shape[1:]
    phys = page_table.clamp_min(0).long()
    x = pages[layer][:, phys].float()               # (Hkv, B, MP, ps, hd)
    x = x.transpose(0, 1).reshape(B, Hkv, MP * ps, hd)
    if scales is None:
        return x, None
    s = scales[layer][:, phys, 0]                   # (Hkv, B, MP, ps)
    return x, s.transpose(0, 1).reshape(B, Hkv, MP * ps)


def _slots(slot_base, ps: int):
    """Global slot (B, MP*ps) of every page position, -1 for dead ones."""
    B, MP = slot_base.shape
    sb = slot_base.long()
    slot = sb[:, :, None] + torch.arange(ps, device=sb.device)
    return torch.where(sb[:, :, None] >= 0, slot, -1).reshape(B, MP * ps)


def _softmax_out(s, v, vs):
    """exp-normalise masked scores s (..., K) against values v (..., K, hd):
    (unnormalised-by-l out, m, l) with v's scale folded in after l."""
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2)
    e = torch.exp(s - m)  # masked scores underflow to exactly 0
    l = e.sum(dim=-1, keepdim=True)
    if vs is not None:
        e = e * vs
    return torch.matmul(e, v), m, l


def _finish(o, m, l):
    l_safe = torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l_safe), NEG_INF)
    return o / l_safe, lse[..., 0]


def paged_decode_attention_torch(q, k_new, v_new, k_pages, v_pages,
                                 page_table, lengths, layer: int, *,
                                 scale: Optional[float] = None,
                                 fresh_in_pages: bool = False,
                                 slot_base=None, fold_fresh: int = 1,
                                 return_lse: bool = False, k_scales=None,
                                 v_scales=None):
    """Plain twin of the decode kernel: one exact fp32 softmax per query
    over the gathered pages (and the fresh tokens)."""
    B, T, Hq, hd = q.shape
    Hkv, ps = k_pages.shape[1], k_pages.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    k, ks = _gather_pages(k_pages, k_scales, page_table, layer)
    v, vs = _gather_pages(v_pages, v_scales, page_table, layer)
    # q row (t, g) of kv head h: (B, Hkv, T*G, hd)
    qf = (q.float() * scale).reshape(B, T, Hkv, G, hd).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(B, Hkv, T * G, hd)
    s = torch.matmul(qf, k.transpose(-1, -2))       # (B, Hkv, T*G, K)
    if ks is not None:
        s = s * ks[:, :, None, :]
    slot = _slots(slot_base, ps)                    # (B, K)
    t_row = torch.arange(T * G, device=q.device) // G
    limit = lengths.long()[:, None] + (t_row[None] if fresh_in_pages else -1)
    mask = (slot[:, None, :] >= 0) & (slot[:, None, :] <= limit[:, :, None])
    s = torch.where(mask[:, None], s, NEG_INF)
    if vs is not None:
        vs = vs[:, :, None, :]
    if not fresh_in_pages and fold_fresh:
        kn = k_new.float().transpose(1, 2)          # (B, Hkv, T, hd)
        vn = v_new.float().transpose(1, 2)
        sn = torch.matmul(qf, kn.transpose(-1, -2))  # (B, Hkv, T*G, T)
        causal = torch.arange(T, device=q.device)[None] <= t_row[:, None]
        s = torch.cat([s, torch.where(causal, sn, NEG_INF)], dim=-1)
        v = torch.cat([v, vn], dim=2)
        if vs is not None:
            vs = torch.cat([vs, torch.ones_like(vs[..., :T])], dim=-1)
    o, m, l = _softmax_out(s, v, vs)
    o, lse = _finish(o, m, l)                       # (B, Hkv, T*G, .)
    out = o.reshape(B, Hkv, T, G, hd).permute(0, 2, 1, 3, 4)
    out = out.reshape(B, T, Hq, hd).to(q.dtype)
    if return_lse:
        lse = lse.reshape(B, Hkv, T, G).transpose(2, 3).reshape(B, Hq, T)
        return out, lse
    return out


def paged_prefill_attention_torch(q, k_pages, v_pages, page_table, lengths,
                                  layer: int, *, scale: Optional[float] = None,
                                  k_scales=None, v_scales=None,
                                  slot_base=None):
    """Plain twin of the prefill kernel, blocked over the chunk's queries
    to bound the score buffer. Returns (out (B,S,Hq,hd), lse (B,Hq,S))."""
    B, S, Hq, hd = q.shape
    Hkv, ps = k_pages.shape[1], k_pages.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    k, ks = _gather_pages(k_pages, k_scales, page_table, layer)
    v, vs = _gather_pages(v_pages, v_scales, page_table, layer)
    slot = _slots(slot_base, ps)
    mask = (slot >= 0) & (slot < lengths.long()[:, None])   # (B, K)
    k, v = k[:, :, None], v[:, :, None]             # (B, Hkv, 1, K, hd)
    if ks is not None:
        ks, vs = ks[:, :, None, None], vs[:, :, None, None]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, TWIN_BLOCK_Q):
        s1 = min(s0 + TWIN_BLOCK_Q, S)
        qb = (q[:, s0:s1].float() * scale).reshape(B, s1 - s0, Hkv, G, hd)
        qb = qb.permute(0, 2, 3, 1, 4)              # (B, Hkv, G, sq, hd)
        s = torch.matmul(qb, k.transpose(-1, -2))   # (B, Hkv, G, sq, K)
        if ks is not None:
            s = s * ks
        s = torch.where(mask[:, None, None, None], s, NEG_INF)
        o, m, l = _softmax_out(s, v, vs)
        o, lb = _finish(o, m, l)
        out[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, s1 - s0, Hq, hd).to(q.dtype)
        lse[:, :, s0:s1] = lb.reshape(B, Hq, s1 - s0)
    return out, lse


def merge_lse(out1, lse1, out2, lse2):
    """Logsumexp-merge two attention partials over disjoint key sets:
    out* (B, S, H, hd), lse* (B, H, S) fp32; a partial with lse -1e30
    contributes zero."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.where(lse1 <= NEG_INF / 2, 0.0, torch.exp(lse1 - m))
    w2 = torch.where(lse2 <= NEG_INF / 2, 0.0, torch.exp(lse2 - m))
    den = torch.clamp(w1 + w2, min=1e-30)
    w1 = (w1 / den).transpose(1, 2)[..., None]      # (B, S, H, 1)
    w2 = (w2 / den).transpose(1, 2)[..., None]
    out = out1.float() * w1 + out2.float() * w2
    return out.to(out1.dtype)


# --------------------------------------------------------------- kernels


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_pool(k_pages, v_pages, k_scales, v_scales, dtype, device):
    """Pool of the given value dtype, or int8 with fp32 scales."""
    if k_pages.ndim != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad pool shapes {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    L, Hkv, NP, ps, hd = k_pages.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged kernels take head dim {HEAD_DIMS}, got {hd}")
    tensors = [k_pages, v_pages]
    if k_scales is None:
        if k_pages.dtype != dtype or v_pages.dtype != dtype:
            raise ValueError(f"pool {k_pages.dtype} for {dtype} queries")
    else:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8:
            raise ValueError(f"scales given for a {k_pages.dtype} pool")
        for s in (k_scales, v_scales):
            if s is None or s.shape != (L, Hkv, NP, 1, ps) \
                    or s.dtype != torch.float32:
                raise ValueError("int8 pool needs (L, Hkv, NP, 1, ps) fp32 "
                                 "k and v scales")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError("pool tensors must be contiguous on the "
                             "queries' device")


def _check_index(B: int, device, *vecs):
    """int32 (B,) or (B, MP) index tensors on ``device``."""
    for t in vecs:
        if t is None:
            continue
        if t.dtype != torch.int32 or t.shape[0] != B or t.ndim > 2 \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"expected contiguous int32 index tensors with "
                             f"{B} rows on {device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def _check_layer(layer: int, k_pages) -> int:
    if not 0 <= int(layer) < k_pages.shape[0]:
        raise ValueError(f"layer {layer} outside the pool's "
                         f"{k_pages.shape[0]} layers")
    return int(layer)


def _route(q: torch.Tensor, kernel: str) -> bool:
    """True for the twin (CPU tensors), False for the kernel (CUDA)."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {q.device}")
    return False


def _launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def store_fresh_token(k_new, v_new, k_pages, v_pages, page_table, lengths,
                      layer: int, *, k_scales=None, v_scales=None):
    """Write each row's fresh (B, 1, Hkv, hd) k/v at slot ``lengths % ps``
    of page ``page_table[b, min(lengths // ps, MP - 1)]`` of ``layer``, in
    place (an int8 pool also takes the scales). Returns the pool tensors,
    as the JAX function does."""
    if _route(k_new, "paged_store"):
        return store_fresh_token_torch(
            k_new, v_new, k_pages, v_pages, page_table, lengths, layer,
            k_scales=k_scales, v_scales=v_scales)
    B, one, Hkv, hd = k_new.shape
    if one != 1 or v_new.shape != k_new.shape or k_new.dtype not in DTYPES \
            or v_new.dtype != k_new.dtype or not k_new.is_contiguous() \
            or not v_new.is_contiguous():
        raise ValueError(f"fresh k/v must be contiguous (B, 1, Hkv, hd) "
                         f"float32/bfloat16, got {tuple(k_new.shape)} "
                         f"{k_new.dtype}")
    _check_pool(k_pages, v_pages, k_scales, v_scales, k_new.dtype,
                k_new.device)
    if k_pages.shape[1] != Hkv or k_pages.shape[4] != hd:
        raise ValueError("fresh k/v do not match the pool's heads")
    _check_index(B, k_new.device, page_table, lengths)
    layer = _check_layer(layer, k_pages)
    from v2pe_tpu_torch.ops import _build

    _, _, NP, ps, _ = k_pages.shape
    err = _build.load().v2pe_paged_store(
        _ptr(k_new), _ptr(v_new), _ptr(k_pages), _ptr(v_pages),
        _ptr(k_scales), _ptr(v_scales), _ptr(page_table), _ptr(lengths),
        B, Hkv, NP, ps, hd, page_table.shape[1], layer,
        int(k_new.dtype == torch.bfloat16), int(k_scales is not None),
        ctypes.c_void_p(torch.cuda.current_stream(k_new.device).cuda_stream))
    _launch("paged_store", err)
    if k_scales is not None:
        return k_pages, v_pages, k_scales, v_scales
    return k_pages, v_pages


def _check_attention(q, k_pages, v_pages, k_scales, v_scales, page_table,
                     lengths, slot_base, layer):
    if q.dtype not in DTYPES or not q.is_contiguous():
        raise ValueError(f"queries must be contiguous float32/bfloat16, got "
                         f"{q.dtype}")
    _check_pool(k_pages, v_pages, k_scales, v_scales, q.dtype, q.device)
    B, _, Hq, hd = q.shape
    Hkv = k_pages.shape[1]
    if k_pages.shape[4] != hd or Hq % Hkv != 0:
        raise ValueError(f"queries {tuple(q.shape)} do not fit the pool "
                         f"{tuple(k_pages.shape)}")
    if page_table.ndim != 2 or lengths.shape != (B,) \
            or slot_base.shape != page_table.shape:
        raise ValueError("page_table/slot_base must be (B, MP), lengths (B,)")
    _check_index(B, q.device, page_table, lengths, slot_base)
    return _check_layer(layer, k_pages)


def paged_decode_attention(q, k_new, v_new, k_pages, v_pages, page_table,
                           lengths, layer: int, *,
                           scale: Optional[float] = None,
                           fresh_in_pages: bool = False, slot_base=None,
                           fold_fresh: int = 1, return_lse: bool = False,
                           k_scales=None, v_scales=None):
    """(B, T, Hq, hd) attention of T <= 16 fresh queries (rope applied)
    over their row's pages, plus the fresh tokens themselves (causal), and
    with ``return_lse`` a (B, Hq, T) fp32 lse. ``lengths`` excludes the
    fresh tokens. ``fold_fresh=0`` leaves the separate fresh tokens out (a
    sequence-sharding gate; one card always folds them)."""
    if _route(q, "paged_decode"):
        return paged_decode_attention_torch(
            q, k_new, v_new, k_pages, v_pages, page_table, lengths, layer,
            scale=scale, fresh_in_pages=fresh_in_pages, slot_base=slot_base,
            fold_fresh=fold_fresh, return_lse=return_lse, k_scales=k_scales,
            v_scales=v_scales)
    B, T, Hq, hd = q.shape
    ps = k_pages.shape[3]
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    layer = _check_attention(q, k_pages, v_pages, k_scales, v_scales,
                             page_table, lengths, slot_base, layer)
    if not 1 <= T <= MAX_FRESH:
        raise ValueError(f"decode takes 1..{MAX_FRESH} fresh tokens, got {T}")
    Hkv = k_pages.shape[1]
    fold = int(bool(fold_fresh) and not fresh_in_pages)
    if fold:
        for t in (k_new, v_new):
            if t is None or t.shape != (B, T, Hkv, hd) or t.dtype != q.dtype \
                    or t.device != q.device or not t.is_contiguous():
                raise ValueError("separate-fresh decode needs contiguous "
                                 "(B, T, Hkv, hd) fresh k/v in q's dtype")
    from v2pe_tpu_torch.ops import _build

    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) \
        if return_lse else None
    err = _build.load().v2pe_paged_decode(
        _ptr(q), _ptr(k_new if fold else None), _ptr(v_new if fold else None),
        _ptr(k_pages), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales),
        _ptr(page_table), _ptr(slot_base), _ptr(lengths), _ptr(out),
        _ptr(lse), B, T, Hq, Hkv, k_pages.shape[2], ps, hd,
        page_table.shape[1], layer, int(q.dtype == torch.bfloat16),
        int(k_scales is not None), int(fresh_in_pages), fold,
        float(hd ** -0.5 if scale is None else scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _launch("paged_decode", err)
    return (out, lse) if return_lse else out


def paged_prefill_attention(q, k_pages, v_pages, page_table, lengths,
                            layer: int, *, scale: Optional[float] = None,
                            k_scales=None, v_scales=None, slot_base=None):
    """Attention of a (B, S, Hq, hd) chunk (rope applied) over the cached
    slots (< lengths) of its row's pages only: (out (B, S, Hq, hd), lse
    (B, Hq, S) fp32), for a :func:`merge_lse` with the chunk's own causal
    attention."""
    if _route(q, "paged_prefill"):
        return paged_prefill_attention_torch(
            q, k_pages, v_pages, page_table, lengths, layer, scale=scale,
            k_scales=k_scales, v_scales=v_scales, slot_base=slot_base)
    B, S, Hq, hd = q.shape
    ps = k_pages.shape[3]
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    layer = _check_attention(q, k_pages, v_pages, k_scales, v_scales,
                             page_table, lengths, slot_base, layer)
    from v2pe_tpu_torch.ops import _build

    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = _build.load().v2pe_paged_prefill(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_scales),
        _ptr(v_scales), _ptr(page_table), _ptr(slot_base), _ptr(lengths),
        _ptr(out), _ptr(lse), B, S, Hq, k_pages.shape[1], k_pages.shape[2],
        ps, hd, page_table.shape[1], layer, int(q.dtype == torch.bfloat16),
        int(k_scales is not None),
        float(hd ** -0.5 if scale is None else scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _launch("paged_prefill", err)
    return out, lse
