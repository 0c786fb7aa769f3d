"""Paged-KV attention: the CUDA kernels' wrappers and their plain twins.

Port of ``v2pe_tpu/ops/paged_attention.py``. The pool is the JAX layout,
(L, Hkv, NP, ps, hd) values plus, for a quantized pool, (L, Hkv, NP, 1, ps)
fp32 scales, and every function takes the WHOLE pool and a layer index:
nothing slices or copies the pool per layer. An int4 pool (JAX:
``jnp.int4`` pages) is int8 bytes of shape (L, Hkv, NP, ps, hd/2): byte d
of a slot holds dim d in its low nibble and dim d + hd/2 in its high one
(:func:`pack_int4`), so a token's vector of one head is whole bytes. The
functions tell an int4 pool from an int8 one by that last dim.

* :func:`store_fresh_token` writes each row's fresh k/v (quantized for an
  int8 pool, and packed for an int4 one) at slot ``lengths % ps`` of its
  current page, in place.
* :func:`paged_decode_attention` attends T <= 16 fresh queries per row over
  the row's pages: either with the fresh tokens already stored
  (``fresh_in_pages``, fresh token t sees slots <= lengths + t) or with the
  fresh k/v folded in separately (slots < lengths plus fresh u <= t). With
  ``store`` it also writes the fresh k/v into the pool in the same launch,
  by :func:`store_fresh_token`'s rule: at T = 1 before it attends with the
  token in the pages, or, folding, the first ``store_n`` tokens of each row
  after the attention (``paged_kv.write_all_layers``' write). A decode step
  then launches no store of its own.
* :func:`paged_prefill_attention` attends a chunk over the cached slots
  (< lengths) only and returns (out, lse) for :func:`merge_lse` with the
  chunk's own causal attention.

Page-table entries of -1 are unallocated; ``slot_base`` (B, MP) gives each
entry's first global slot, -1 for a dead entry, which is skipped. A store's
``fresh_pages`` (B,) names each row's page outright, -1 for no write (a
sequence shard's store: JAX's override of the page lookup). Quantized
pools: the k scale multiplies the score before the softmax, the v scale
multiplies the softmax weight after the sum l was taken, so l stays
unscaled. A row with nothing to attend gives out 0 and lse -1e30.

Sequence shards (the pool's page axis split n ways, JAX's ``seq`` axis):
:func:`shard_views` gives each shard its compacted local table
(:func:`local_page_view`), :func:`seq_sharded_store_fresh_token`,
:func:`seq_sharded_paged_decode_attention` and
:func:`seq_sharded_chunked_prefill_attention` run the kernels once a shard
and :func:`merge_shards` meets their partials by logsumexp, over the shards
of this process and, given a process group, over the other processes' with
two all-reduces. JAX's ``tensor``-only arms (``sharded_*``) are the kernels
themselves on a rank's local heads.

The kernels are ``csrc/paged_attention.cu`` (built by ``ops/_build.py``).
Each wrapper runs the twin for CPU tensors and the kernel for CUDA tensors,
and never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_FRESH = 16          # fresh tokens a decode call takes
TWIN_BLOCK_Q = 512      # chunk rows per step of the prefill twin

# Kernel launches since the last reset, by kernel: the smoke run zeroes
# them, drives the serving path, and reads how often it went through each.
# "paged_decode_store" counts the decode launches that also stored their
# fresh tokens (the store riding in the decode kernel).
LAUNCHES = {"paged_store": 0, "paged_decode": 0, "paged_decode_store": 0,
            "paged_prefill": 0}

SMS = 132            # streaming multiprocessors of an H100
DECODE_ROWS = 16     # query rows a decode block holds at most (two a warp)
DECODE_SLOTS = 64    # page slots a stage of the decode kernel


class DecodePlan(NamedTuple):
    """One launch of the decode kernel (:func:`decode_plan`)."""
    splits: int      # blocks that share a row's slots
    span: int        # consecutive slots of the row a split owns (a
                     # multiple of DECODE_SLOTS; the last split fewer)
    rows: int        # query rows a block: 2, 4, 8 or 16
    row_blocks: int  # blocks that share a (row, kv head)'s T * G query rows


@functools.lru_cache(maxsize=4096)
def decode_plan(B: int, Hkv: int, MP: int, ps: int, T: int,
                G: int) -> DecodePlan:
    """The decode kernel's launch from shapes alone: B rows, Hkv kv heads
    of G query heads each, MP page-table entries of ps slots a row, T fresh
    tokens. It never reads the lengths, which live on the device (the
    engine's decode block reads the card once a block).

    A block holds up to 16 query rows of one (row, kv head); the row's MP *
    ps slots (its entries in order) are cut into ``splits`` runs of ``span``
    slots, as many as fill the card's two resident blocks an SM in one wave
    (a second, partial wave would double the time). A split over slots past
    a row's end writes an empty partial."""
    B, Hkv, MP, ps, T, G = (int(x) for x in (B, Hkv, MP, ps, T, G))
    if min(B, Hkv, ps, T, G) < 1 or MP < 0:
        raise ValueError(f"no decode launch for B={B}, Hkv={Hkv}, MP={MP}, "
                         f"ps={ps}, T={T}, G={G}")
    R = T * G
    rows = 2
    while rows < min(R, DECODE_ROWS):
        rows *= 2
    row_blocks = -(-R // rows)
    base = B * Hkv * row_blocks
    want = max(1, 2 * SMS // base)
    V = max(MP * ps, 1)
    span = -(-(-(-V // want)) // DECODE_SLOTS) * DECODE_SLOTS
    splits = -(-V // span)
    return DecodePlan(splits, span, rows, row_blocks)


# the device's decode workspace and zeroed split counters, kept between
# calls (device index -> (workspace, counters)); the last block of each
# (row, kv head, row block) resets its counter
_DECODE_SCRATCH = {}


def _decode_scratch(device, floats: int, cells: int):
    """The device's workspace (at least ``floats`` fp32) and counters (at
    least ``cells``), grown when a launch needs more, never per call."""
    ws, counters = _DECODE_SCRATCH.get(device.index, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                         device=device)
    if counters is None or counters.numel() < cells:
        counters = torch.zeros(max(cells, 4096), dtype=torch.int32,
                               device=device)
    _DECODE_SCRATCH[device.index] = (ws, counters)
    return ws, counters


def default_slot_base(page_table: torch.Tensor, page_size: int):
    """Entry j of a row starts at global slot j * page_size; -1 entries
    are dead."""
    MP = page_table.shape[1]
    base = torch.arange(MP, dtype=torch.int32,
                        device=page_table.device)[None] * page_size
    return torch.where(page_table >= 0, base, -1).to(torch.int32)


def quantize_kv(x: torch.Tensor, bits: int = 8):
    """Symmetric int8 / int4 quantization per vector of the last dim:
    returns (codes as int8, one per value, fp32 scales with the last dim
    kept as 1). The scale is amax/qmax (qmax 127, or 7 for ``bits=4``), or 1
    where amax is 0; values round half to even and clip to +-qmax. int4
    codes go into a pool through :func:`pack_int4`."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_kv takes 4 or 8 bits, got {bits}")
    qmax = 7.0 if bits == 4 else 127.0
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not jnp's (nor the store kernel's) exact division
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(..., hd) int8 codes in [-7, 7] -> (..., hd/2) bytes: dim d in the low
    nibble, dim d + hd/2 in the high one."""
    h = codes.shape[-1] // 2
    lo, hi = codes[..., :h].to(torch.int32), codes[..., h:].to(torch.int32)
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: (..., hd/2) bytes -> (..., hd) int8
    codes (the low nibble sign-extended, the high one by an arithmetic
    shift)."""
    b = packed.to(torch.int32)
    return torch.cat([((b & 0xF) ^ 8) - 8, b >> 4], dim=-1).to(torch.int8)


def pool_bits(k_pages: torch.Tensor, k_scales, hd: int) -> int:
    """0 for a pool in the values' own dtype, 8 for int8 codes, 4 for packed
    int4 (quantized, and half of ``hd`` bytes per slot)."""
    if k_scales is None:
        return 0
    return 4 if k_pages.shape[-1] * 2 == hd else 8


# ---------------------------------------------------------------- twins


def store_fresh_token_torch(k_new, v_new, k_pages, v_pages, page_table,
                            lengths, layer: int, *, k_scales=None,
                            v_scales=None, store_n=None, fresh_pages=None):
    """Plain twin of the store: each row's (B, T, Hkv, hd) fresh k/v, the
    first ``store_n`` (B,) of them (all T where None), at positions lengths
    + t: entry min(pos // ps, MP - 1) of the page table, offset pos % ps, no
    write where that entry is -1. ``fresh_pages`` (B,), one token a row:
    the page itself, -1 for none. Writes the pool in place."""
    B, T = k_new.shape[:2]
    ps = k_pages.shape[3]
    MP = page_table.shape[1]
    t = torch.arange(T, device=lengths.device)[None]
    pos = lengths.long()[:, None] + t                # (B, T)
    if fresh_pages is None:
        page = torch.gather(page_table.long(), 1,
                            torch.clamp(pos // ps, max=MP - 1))
    else:
        if T != 1:
            raise ValueError(f"fresh_pages places one token a row, got {T}")
        page = fresh_pages.long()[:, None]
    ok = page >= 0  # an unallocated page takes no write
    if store_n is not None:
        ok &= t < store_n.long()[:, None]
    page, off = page[ok], (pos % ps)[ok]
    kn, vn = k_new[ok], v_new[ok]                 # (n, Hkv, hd)
    if k_scales is not None:
        bits = pool_bits(k_pages, k_scales, k_new.shape[-1])
        kn, ks = quantize_kv(kn, bits)
        vn, vs = quantize_kv(vn, bits)
        if bits == 4:
            kn, vn = pack_int4(kn), pack_int4(vn)
        k_scales[layer][:, page, 0, off] = ks[..., 0].t()
        v_scales[layer][:, page, 0, off] = vs[..., 0].t()
    k_pages[layer][:, page, off] = kn.transpose(0, 1).to(k_pages.dtype)
    v_pages[layer][:, page, off] = vn.transpose(0, 1).to(v_pages.dtype)
    if k_scales is not None:
        return k_pages, v_pages, k_scales, v_scales
    return k_pages, v_pages


def _gather_pages(pages, scales, page_table, layer: int, hd: int):
    """(B, Hkv, MP*ps, hd) fp32 values of each row's pages (page -1 reads
    page 0, masked by the caller; int4 bytes unpacked) and their
    (B, Hkv, MP*ps) scales."""
    B, MP = page_table.shape
    Hkv, _, ps, _ = pages.shape[1:]
    phys = page_table.clamp_min(0).long()
    x = pages[layer][:, phys]                       # (Hkv, B, MP, ps, .)
    if pool_bits(pages, scales, hd) == 4:
        x = unpack_int4(x)
    x = x.float().transpose(0, 1).reshape(B, Hkv, MP * ps, hd)
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


def _softmax_out(s, v, vs, rounding=None):
    """exp-normalise masked scores s (..., K) against values v (..., K, hd):
    (unnormalised-by-l out, m, l) with v's scale folded in after l; with
    ``rounding`` (bf16) the weights are rounded to it for the product, as
    the tensor cores take them."""
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2)
    e = torch.exp(s - m)  # masked scores underflow to exactly 0
    l = e.sum(dim=-1, keepdim=True)
    if vs is not None:
        e = e * vs
    if rounding is not None:
        e = e.to(rounding).float()
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
                                 v_scales=None, store: bool = False,
                                 store_n=None, fresh_pages=None):
    """Plain twin of the decode kernel: one exact fp32 softmax per query
    over the gathered pages (and the fresh tokens). ``store``: the store
    twin before it (``fresh_in_pages``) or after it (folding)."""
    pool = (k_pages, v_pages, page_table, lengths, layer)
    scales = dict(k_scales=k_scales, v_scales=v_scales)
    if store and fresh_in_pages:
        store_fresh_token_torch(k_new, v_new, *pool, store_n=store_n,
                                fresh_pages=fresh_pages, **scales)
    res = _decode_torch(q, k_new, v_new, *pool, scale=scale,
                        fresh_in_pages=fresh_in_pages, slot_base=slot_base,
                        fold_fresh=fold_fresh, return_lse=return_lse,
                        **scales)
    if store and not fresh_in_pages:
        store_fresh_token_torch(k_new, v_new, *pool, store_n=store_n,
                                **scales)
    return res


def _decode_torch(q, k_new, v_new, k_pages, v_pages, page_table, lengths,
                  layer: int, *, scale, fresh_in_pages, slot_base, fold_fresh,
                  return_lse, k_scales, v_scales):
    B, T, Hq, hd = q.shape
    Hkv, ps = k_pages.shape[1], k_pages.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    k, ks = _gather_pages(k_pages, k_scales, page_table, layer, hd)
    v, vs = _gather_pages(v_pages, v_scales, page_table, layer, hd)
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
    to bound the score buffer. Returns (out (B,S,Hq,hd), lse (B,Hq,S)).

    fp32 queries: exact fp32. bf16 queries round where the kernel's tensor
    cores do (flash_attention_fwd_torch's bf16 rounding, Pallas bf16all):
    bf16 q and K/V (pool values, or int8 / int4 codes, which bf16 holds
    exactly), the scale and the k scale on the fp32 scores, the softmax
    weights times the v scale rounded to bf16 for the product with V; m, l
    and the sums in fp32."""
    B, S, Hq, hd = q.shape
    Hkv, ps = k_pages.shape[1], k_pages.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = hd ** -0.5
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    k, ks = _gather_pages(k_pages, k_scales, page_table, layer, hd)
    v, vs = _gather_pages(v_pages, v_scales, page_table, layer, hd)
    slot = _slots(slot_base, ps)
    mask = (slot >= 0) & (slot < lengths.long()[:, None])   # (B, K)
    k, v = k[:, :, None], v[:, :, None]             # (B, Hkv, 1, K, hd)
    if ks is not None:
        ks, vs = ks[:, :, None, None], vs[:, :, None, None]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    for s0 in range(0, S, TWIN_BLOCK_Q):
        s1 = min(s0 + TWIN_BLOCK_Q, S)
        qb = q[:, s0:s1].float()
        if not bf16:
            qb = qb * scale
        qb = qb.reshape(B, s1 - s0, Hkv, G, hd)
        qb = qb.permute(0, 2, 3, 1, 4)              # (B, Hkv, G, sq, hd)
        s = torch.matmul(qb, k.transpose(-1, -2))   # (B, Hkv, G, sq, K)
        if bf16:
            s = s * scale
        if ks is not None:
            s = s * ks
        s = torch.where(mask[:, None, None, None], s, NEG_INF)
        o, m, l = _softmax_out(s, v, vs, torch.bfloat16 if bf16 else None)
        o, lb = _finish(o, m, l)
        out[:, s0:s1] = o.permute(0, 3, 1, 2, 4).reshape(
            B, s1 - s0, Hq, hd).to(q.dtype)
        lse[:, :, s0:s1] = lb.reshape(B, Hq, s1 - s0)
    return out, lse


def merge_partials(out1, lse1, out2, lse2):
    """Logsumexp-merge two attention partials over disjoint key sets:
    out* (B, S, H, hd), lse* (B, H, S) fp32; a partial with lse -1e30
    contributes zero. Returns (out fp32, lse); where both partials are
    empty, out is 0 and lse stays -1e30."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.where(lse1 <= NEG_INF / 2, 0.0, torch.exp(lse1 - m))
    w2 = torch.where(lse2 <= NEG_INF / 2, 0.0, torch.exp(lse2 - m))
    total = w1 + w2
    den = torch.clamp(total, min=1e-30)
    lse = torch.where(total > 0, m + torch.log(den), NEG_INF)
    w1 = (w1 / den).transpose(1, 2)[..., None]      # (B, S, H, 1)
    w2 = (w2 / den).transpose(1, 2)[..., None]
    return out1.float() * w1 + out2.float() * w2, lse


def merge_lse(out1, lse1, out2, lse2):
    """:func:`merge_partials`' output alone, in out1's dtype."""
    return merge_partials(out1, lse1, out2, lse2)[0].to(out1.dtype)


# --------------------------------------------------------------- kernels


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_pool(k_pages, v_pages, k_scales, v_scales, dtype, device,
                hd: int) -> int:
    """Pool of the given value dtype, or int8 (codes, or packed int4 with
    hd/2 bytes a slot) with fp32 scales, for values of head dim ``hd``.
    Returns its :func:`pool_bits`."""
    if k_pages.ndim != 5 or k_pages.shape != v_pages.shape:
        raise ValueError(f"bad pool shapes {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    L, Hkv, NP, ps, width = k_pages.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged kernels take head dim {HEAD_DIMS}, got {hd}")
    bits = pool_bits(k_pages, k_scales, hd)
    if width != (hd // 2 if bits == 4 else hd):
        raise ValueError(f"pool slots of {width} values for head dim {hd}")
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
                raise ValueError("a quantized pool needs (L, Hkv, NP, 1, ps) "
                                 "fp32 k and v scales")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != device or not t.is_contiguous():
            raise ValueError("pool tensors must be contiguous on the "
                             "queries' device")
    return bits


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
                      layer: int, *, k_scales=None, v_scales=None,
                      fresh_pages=None):
    """Write each row's fresh (B, 1, Hkv, hd) k/v at slot ``lengths % ps``
    of page ``page_table[b, min(lengths // ps, MP - 1)]`` of ``layer``, in
    place (a quantized pool also takes the scales); with ``fresh_pages``
    (B,) int32 of page ``fresh_pages[b]``, nothing where it is -1. Returns
    the pool tensors, as the JAX function does."""
    if _route(k_new, "paged_store"):
        return store_fresh_token_torch(
            k_new, v_new, k_pages, v_pages, page_table, lengths, layer,
            k_scales=k_scales, v_scales=v_scales, fresh_pages=fresh_pages)
    B, one, Hkv, hd = k_new.shape
    if one != 1 or v_new.shape != k_new.shape or k_new.dtype not in DTYPES \
            or v_new.dtype != k_new.dtype or not k_new.is_contiguous() \
            or not v_new.is_contiguous():
        raise ValueError(f"fresh k/v must be contiguous (B, 1, Hkv, hd) "
                         f"float32/bfloat16, got {tuple(k_new.shape)} "
                         f"{k_new.dtype}")
    bits = _check_pool(k_pages, v_pages, k_scales, v_scales, k_new.dtype,
                       k_new.device, hd)
    if k_pages.shape[1] != Hkv:
        raise ValueError("fresh k/v do not match the pool's heads")
    _check_index(B, k_new.device, page_table, lengths, fresh_pages)
    _check_vector(fresh_pages)
    layer = _check_layer(layer, k_pages)
    from v2pe_tpu_torch.ops import _build

    _, _, NP, ps, _ = k_pages.shape
    err = _build.load().v2pe_paged_store(
        _ptr(k_new), _ptr(v_new), _ptr(k_pages), _ptr(v_pages),
        _ptr(k_scales), _ptr(v_scales), _ptr(page_table), _ptr(lengths),
        _ptr(fresh_pages), B, Hkv, NP, ps, hd, page_table.shape[1], layer,
        int(k_new.dtype == torch.bfloat16), bits,
        _build.raw_stream(k_new.device.index))
    _launch("paged_store", err)
    if k_scales is not None:
        return k_pages, v_pages, k_scales, v_scales
    return k_pages, v_pages


def _check_vector(t) -> None:
    if t is not None and t.ndim != 1:
        raise ValueError(f"expected a (B,) index vector, got {tuple(t.shape)}")


def _check_store(q, k_new, v_new, k_pages, store_n, fresh_in_pages,
                 fresh_pages=None):
    """A decode launch's store: contiguous (B, T, Hkv, hd) fresh k/v in q's
    dtype on its device (T = 1 to store, then attend), ``store_n`` and
    ``fresh_pages`` None or contiguous (B,) int32 there; ``fresh_pages``
    for a store-then-attend only (a folding store finds its pages in the
    table)."""
    B, T, _, hd = q.shape
    want = (B, T, k_pages.shape[1], hd)
    for t in (k_new, v_new):
        if t is None or t.shape != want or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"a store needs contiguous {want} fresh k/v "
                             f"in q's dtype")
    if fresh_in_pages and T != 1:
        raise ValueError(f"store-then-attend takes one fresh token, got {T}")
    if store_n is not None:
        _check_index(B, q.device, store_n)
        if store_n.ndim != 1:
            raise ValueError("store_n must be (B,)")
    if fresh_pages is not None:
        if not fresh_in_pages:
            raise ValueError("fresh_pages places a store-then-attend's one "
                             "token; a folding store finds its pages in "
                             "the table")
        _check_index(B, q.device, fresh_pages)
        _check_vector(fresh_pages)


def _check_attention(q, k_pages, v_pages, k_scales, v_scales, page_table,
                     lengths, slot_base, layer):
    if q.dtype not in DTYPES or not q.is_contiguous():
        raise ValueError(f"queries must be contiguous float32/bfloat16, got "
                         f"{q.dtype}")
    B, _, Hq, hd = q.shape
    bits = _check_pool(k_pages, v_pages, k_scales, v_scales, q.dtype,
                       q.device, hd)
    Hkv = k_pages.shape[1]
    if Hq % Hkv != 0:
        raise ValueError(f"queries {tuple(q.shape)} do not fit the pool "
                         f"{tuple(k_pages.shape)}")
    if page_table.ndim != 2 or lengths.shape != (B,) \
            or slot_base.shape != page_table.shape:
        raise ValueError("page_table/slot_base must be (B, MP), lengths (B,)")
    _check_index(B, q.device, page_table, lengths, slot_base)
    return _check_layer(layer, k_pages), bits


def paged_decode_attention(q, k_new, v_new, k_pages, v_pages, page_table,
                           lengths, layer: int, *,
                           scale: Optional[float] = None,
                           fresh_in_pages: bool = False, slot_base=None,
                           fold_fresh: int = 1, return_lse: bool = False,
                           k_scales=None, v_scales=None, store: bool = False,
                           store_n=None, fresh_pages=None):
    """(B, T, Hq, hd) attention of T <= 16 fresh queries (rope applied)
    over their row's pages, plus the fresh tokens themselves (causal), and
    with ``return_lse`` a (B, Hq, T) fp32 lse. ``lengths`` excludes the
    fresh tokens. ``fold_fresh=0`` leaves the separate fresh tokens out (a
    sequence-sharding gate; one card always folds them).

    ``store``: the launch also writes the (B, T, Hkv, hd) fresh k/v into
    the pool in place, as :func:`store_fresh_token` does (quantized and
    packed for an int8 / int4 pool). With ``fresh_in_pages`` (T = 1) it
    stores first and attends the token as stored; folding, it attends the
    fresh tokens unquantized and stores the first ``store_n`` (B,) int32 of
    each row (all T where None) at lengths + t. ``fresh_pages`` (B,) int32
    (store-then-attend): each row's page, -1 for no store, the entry that
    holds it found among the row's (a sequence shard's compacted table)."""
    if store:
        _check_store(q, k_new, v_new, k_pages, store_n, fresh_in_pages,
                     fresh_pages)
    elif fresh_pages is not None:
        raise ValueError("fresh_pages without a store")
    if _route(q, "paged_decode"):
        return paged_decode_attention_torch(
            q, k_new, v_new, k_pages, v_pages, page_table, lengths, layer,
            scale=scale, fresh_in_pages=fresh_in_pages, slot_base=slot_base,
            fold_fresh=fold_fresh, return_lse=return_lse, k_scales=k_scales,
            v_scales=v_scales, store=store, store_n=store_n,
            fresh_pages=fresh_pages)
    B, T, Hq, hd = q.shape
    ps = k_pages.shape[3]
    if slot_base is None:
        slot_base = default_slot_base(page_table, ps)
    layer, bits = _check_attention(q, k_pages, v_pages, k_scales, v_scales,
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

    MP = page_table.shape[1]
    plan = decode_plan(B, Hkv, MP, ps, T, Hq // Hkv)
    if store and fresh_in_pages and plan.row_blocks != 1:
        raise ValueError(f"store-then-attend takes at most {DECODE_ROWS} "
                         f"query heads a kv head, got {Hq // Hkv}")
    ws = counters = None
    # a folding store over more than one block a (row, kv head) meets on
    # one more counter each, after the splits' counters
    meet = store and not fresh_in_pages and plan.splits * plan.row_blocks > 1
    if plan.splits > 1 or meet:
        cells = B * Hkv * plan.row_blocks
        ws, counters = _decode_scratch(
            q.device, cells * plan.splits * plan.rows * (hd + 2),
            cells + (B * Hkv if meet else 0))
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) \
        if return_lse else None
    fresh = fold or store
    err = _build.load().v2pe_paged_decode(
        _ptr(q), _ptr(k_new if fresh else None),
        _ptr(v_new if fresh else None),
        _ptr(k_pages), _ptr(v_pages), _ptr(k_scales), _ptr(v_scales),
        _ptr(page_table), _ptr(slot_base), _ptr(lengths), _ptr(out),
        _ptr(lse), B, T, Hq, Hkv, k_pages.shape[2], ps, hd, MP, layer,
        int(q.dtype == torch.bfloat16), bits, int(fresh_in_pages), fold,
        float(hd ** -0.5 if scale is None else scale), plan.splits,
        plan.span, plan.rows, _ptr(ws), _ptr(counters), int(store),
        _ptr(store_n), _ptr(fresh_pages), _build.raw_stream(q.device.index))
    _launch("paged_decode", err)
    if store:
        LAUNCHES["paged_decode_store"] += 1
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
    layer, bits = _check_attention(q, k_pages, v_pages, k_scales, v_scales,
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
        bits, float(hd ** -0.5 if scale is None else scale),
        k_pages.shape[0], _build.raw_stream(q.device.index))
    _launch("paged_prefill", err)
    return out, lse


# ------------------------------------------------------- sequence shards


class ShardView(NamedTuple):
    """One sequence shard's view of a pool's global page table
    (:func:`shard_views`)."""
    shard: int
    page_table: torch.Tensor   # (B, MPl) ids in the pool this process
    #                            holds, -1 for dead entries
    slot_base: torch.Tensor    # (B, MPl) each entry's first global slot
    fresh_pages: Optional[torch.Tensor]  # (B,) the page of slot lengths
    #                            in that pool, -1 where another shard has it


def local_page_view(page_table: torch.Tensor, shard: int, n_shards: int,
                    n_pages: int):
    """JAX's ``_local_page_view`` for shard ``shard`` of ``n_shards`` over a
    pool of ``n_pages`` global pages (shard d holds [d NP/n, (d+1) NP/n)):
    the shard's pages of each row compacted to the front in table order,
    as shard-local ids, sliced to MPl = min(MP, ceil(MP/n) + 1) entries
    (the round-robin placement bounds a row's pages on a shard by
    ceil(MP/n)); and each entry's table slot, -1 for dead ones. Returns
    (local ids (B, MPl), table slots (B, MPl)), int32."""
    B, MP = page_table.shape
    NPl = n_pages // n_shards
    lo = shard * NPl
    owned = (page_table >= lo) & (page_table < lo + NPl)
    order = torch.argsort((~owned).to(torch.int8), dim=1, stable=True)
    order = order[:, :min(MP, -(-MP // n_shards) + 1)]
    own = torch.gather(owned, 1, order)
    ids = torch.where(own, torch.gather(page_table, 1, order) - lo, -1)
    slots = torch.where(own, order, -1)
    return ids.to(torch.int32), slots.to(torch.int32)


def shard_views(page_table: torch.Tensor, lengths: torch.Tensor,
                n_shards: int, n_pages: int, page_size: int,
                held: Optional[int] = None, fresh: bool = False):
    """The views of the shards this process runs: all ``n_shards`` when its
    pool holds every page (``held`` None: one card), else shard ``held``
    alone, whose pool holds only its NP/n pages. Table ids index that pool
    (shard-local ids plus the shard's first page on one card); ``fresh``
    adds each row's page of slot ``lengths`` for a store."""
    NPl = n_pages // n_shards
    MP = page_table.shape[1]
    phys = None
    if fresh:
        at = torch.clamp(lengths.long() // page_size, max=MP - 1)[:, None]
        phys = torch.gather(page_table, 1, at)[:, 0]
    views = []
    for d in (range(n_shards) if held is None else (held,)):
        ids, slots = local_page_view(page_table, d, n_shards, n_pages)
        base = d * NPl if held is None else 0
        fp = None
        if fresh:
            mine = (phys >= d * NPl) & (phys < (d + 1) * NPl)
            fp = torch.where(mine, phys - d * NPl + base, -1).to(torch.int32)
        views.append(ShardView(
            d, torch.where(ids >= 0, ids + base, -1).to(torch.int32),
            torch.where(slots >= 0, slots * page_size, -1).to(torch.int32),
            fp))
    return views


def merge_shards(parts, group=None) -> torch.Tensor:
    """Logsumexp merge of partials over disjoint key sets: ``parts`` is this
    process's [(out (B, S, H, hd), lse (B, H, S) fp32)], and over ``group``
    (a process group) every other process's too, by one MAX all-reduce of
    the lse and one SUM all-reduce of numerator and denominator packed
    together. A partial with lse -1e30 weighs 0; a query that attends
    nothing comes out 0. Returns fp32 (B, S, H, hd)."""
    lse = torch.stack([p[1] for p in parts])            # (n, B, H, S)
    m = lse.amax(dim=0)
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.where(lse <= NEG_INF / 2, 0.0, torch.exp(lse - m))
    num = sum(out.float() * wi.transpose(1, 2)[..., None]
              for (out, _), wi in zip(parts, w))
    den = w.sum(dim=0)
    if group is not None:
        import torch.distributed as dist

        flat = torch.cat([num.reshape(-1), den.reshape(-1)])
        dist.all_reduce(flat, group=group)
        num = flat[:num.numel()].view_as(num)
        den = flat[num.numel():].view_as(den)
    return num / den.clamp_min(1e-30).transpose(1, 2)[..., None]


def seq_sharded_store_fresh_token(k_new, v_new, k_pages, v_pages, views,
                                  lengths, layer: int, *, k_scales=None,
                                  v_scales=None):
    """The fresh token of each row into whichever of ``views``' shards owns
    its page (JAX's ``seq_sharded_store_fresh_token``): one store a shard,
    each told its rows' pages by ``fresh_pages`` (-1: another shard's)."""
    for v in views:
        out = store_fresh_token(k_new, v_new, k_pages, v_pages, v.page_table,
                                lengths, layer, k_scales=k_scales,
                                v_scales=v_scales, fresh_pages=v.fresh_pages)
    return out


def seq_sharded_paged_decode_attention(q, k_new, v_new, k_pages, v_pages,
                                       views, lengths, layer: int, *,
                                       scale: Optional[float] = None,
                                       fresh_in_pages: bool = False,
                                       k_scales=None, v_scales=None,
                                       store: bool = False, group=None):
    """Decode attention over a pool sharded on its page axis (JAX's
    ``seq_sharded_paged_decode_attention``): one decode launch a shard over
    its compacted table with (out, lse), the separate fresh tokens folded on
    shard 0 alone, merged by :func:`merge_shards`. ``store`` (T = 1, fresh
    in the pages): each shard's launch first stores the rows whose fresh
    page it owns."""
    parts = [paged_decode_attention(
        q, k_new, v_new, k_pages, v_pages, v.page_table, lengths, layer,
        scale=scale, fresh_in_pages=fresh_in_pages, slot_base=v.slot_base,
        fold_fresh=int(v.shard == 0), return_lse=True, k_scales=k_scales,
        v_scales=v_scales, store=store,
        fresh_pages=v.fresh_pages if store else None) for v in views]
    return merge_shards(parts, group).to(q.dtype)


def seq_sharded_chunked_prefill_attention(q, k, v, segment_ids, k_pages,
                                          v_pages, views, lengths,
                                          layer: int, *, k_scales=None,
                                          v_scales=None, group=None):
    """Chunked-prefill attention over a page-sharded pool (JAX's
    ``seq_sharded_chunked_prefill_attention``): each shard sweeps its own
    pages; the chunk's causal self-attention counts on shard 0 only, merged
    there with its sweep; then the shards' partials meet by
    :func:`merge_shards`."""
    from v2pe_tpu_torch.ops.attention import flash_attention_with_lse

    parts = []
    for view in views:
        part = paged_prefill_attention(
            q, k_pages, v_pages, view.page_table, lengths, layer,
            k_scales=k_scales, v_scales=v_scales, slot_base=view.slot_base)
        if view.shard == 0:
            own = flash_attention_with_lse(
                q, k, v, q_segment_ids=segment_ids,
                kv_segment_ids=segment_ids, causal=True)
            part = merge_partials(*own, *part)
        parts.append(part)
    return merge_shards(parts, group).to(q.dtype)
