"""Paged latent attention (kernel #12): the CUDA kernel's wrapper and its
plain twin.

The pool is a latent pool, ``infer/paged_kv.py``: (L, 1, NP, ps, 576),
each slot a token's 512 latents (after ``kv_a_layernorm``) and its 64
rotary key dims. Queries come absorbed, (B, T, H, 576): ``q_nope W_UK``
then ``q_pe``; the output is the softmax-weighted sum of the latents, (B,
T, H, 512), which the caller multiplies by ``W_UV``. Two forms:

* :func:`mla_decode`: one token a row (the engine's decode step). The
  step's latent ``fresh`` (B, 576) is stored at slot ``lengths`` of its
  row's page, and the query attends slots 0..lengths, itself included, in
  one launch; a row whose entry there is dead (-1) stores nothing.
* :func:`mla_chunk`: a prefill chunk whose latents are in the pool already
  (the caller stores them first: :func:`latent_slots` once a forward,
  :func:`store_latents` a layer): chunk token t attends slots 0 ..
  lengths + t, the row's cached pages and the chunk, causal.

Page-table entries of -1 are dead: their slots are skipped. The kernel is
``csrc/mla_attention.cu`` (bf16, 16 heads a group, 576 / 512 dims); each
wrapper runs the twin for CPU tensors and the kernel for CUDA tensors, and
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

DK, DV, HG = 576, 512, 16
KT = 32                 # slots a tile of the kernel
SMS = 132               # streaming multiprocessors of an H100

# Kernel launches since the last reset, by form.
LAUNCHES = {"mla_decode": 0, "mla_chunk": 0}

# the device's decode workspace and zeroed split counters, kept between
# calls (device index -> (workspace, counters)); the merging block resets
# its counter
_SCRATCH = {}


@functools.lru_cache(maxsize=1024)
def decode_splits(B: int, H: int, MP: int, ps: int):
    """(splits, span) of the decode form from shapes alone (never the
    lengths, which live on the device): a row's MP * ps slots cut into runs
    of a multiple of 32 slots, about eight blocks an SM over the rows and
    head groups."""
    cap = max(MP * ps, 1)
    want = max(1, 8 * SMS // max(B * (H // HG), 1))
    span = -(-(-(-cap // want)) // KT) * KT
    return -(-cap // span), span


def _scratch(device, floats: int, cells: int):
    ws, counters = _SCRATCH.get(device.index, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                         device=device)
    if counters is None or counters.numel() < cells:
        counters = torch.zeros(max(cells, 1024), dtype=torch.int32,
                               device=device)
    _SCRATCH[device.index] = (ws, counters)
    return ws, counters


# ---------------------------------------------------------------- twins


def _row_slots(pool, layer: int, page_table):
    """(B, MP * ps, 576) fp32 latents of each row through its table, and
    (B, MP * ps) whether the slot's entry is live."""
    B, MP = page_table.shape
    ps = pool.shape[3]
    lat = pool[layer, 0][page_table.clamp_min(0).long()]   # (B, MP, ps, DK)
    live = (page_table >= 0)[:, :, None].expand(B, MP, ps)
    return lat.reshape(B, MP * ps, -1).float(), live.reshape(B, MP * ps)


def _attend(q, lat, keep, scale: float, dv: int):
    """softmax(q lat^T * scale) lat[..., :dv] over the kept slots; q (B, T,
    H, dk), lat (B, N, dk), keep (B, T, N). A row with nothing kept gives
    0."""
    s = torch.einsum("bthd,bnd->bthn", q.float(), lat) * scale
    s = s.masked_fill(~keep[:, :, None], float("-inf"))
    w = torch.softmax(s, -1).nan_to_num(0.0)
    return torch.einsum("bthn,bnd->bthd", w, lat[..., :dv])


def mla_decode_torch(q, fresh, pool, page_table, lengths, layer: int,
                     scale: float, dv: int):
    """Plain twin of :func:`mla_decode`: store, then attend."""
    store_latents(pool, layer, latent_slots(page_table, lengths, 1,
                                            pool.shape[3]), fresh[:, None])
    lat, live = _row_slots(pool, layer, page_table)
    slot = torch.arange(lat.shape[1], device=q.device)[None]
    keep = (live & (slot <= lengths[:, None].long()))[:, None]
    return _attend(q[:, None], lat, keep, scale, dv)[:, 0].to(q.dtype)


def mla_chunk_torch(q, pool, page_table, lengths, layer: int, scale: float,
                    dv: int):
    """Plain twin of :func:`mla_chunk`."""
    T = q.shape[1]
    lat, live = _row_slots(pool, layer, page_table)
    slot = torch.arange(lat.shape[1], device=q.device)
    lim = lengths.long()[:, None] + torch.arange(T, device=q.device)[None]
    keep = live[:, None] & (slot[None, None] <= lim[..., None])
    return _attend(q, lat, keep, scale, dv).to(q.dtype)


# ------------------------------------------------------------- the pool


def latent_slots(page_table, lengths, T: int, ps: int,
                 valid: Optional[torch.Tensor] = None):
    """Where T tokens a row go, at each row's length: (flat slots page * ps
    + offset, the flat (B * T) indices of the tokens written there). A
    token is written iff its entry is live and, when given, it is among the
    first ``valid`` (B,) of its row. Reads the count back once."""
    MP = page_table.shape[1]
    dev = lengths.device
    pos = lengths.long()[:, None] + torch.arange(T, device=dev)[None]
    entry = torch.gather(page_table.long(), 1, (pos // ps).clamp(max=MP - 1))
    ok = (entry >= 0) & (pos // ps < MP)
    if valid is not None:
        ok &= torch.arange(T, device=dev)[None] < valid[:, None]
    take = ok.reshape(-1).nonzero()[:, 0]
    return (entry * ps + pos % ps).reshape(-1)[take], take


def store_latents(pool, layer: int, slots, lat) -> None:
    """Write (B, T, 576) latents into layer ``layer`` of the pool at
    :func:`latent_slots`' (slots, token indices), in place."""
    NP, ps = pool.shape[2], pool.shape[3]
    where, take = slots
    pool[layer, 0].view(NP * ps, -1)[where] = \
        lat.reshape(-1, lat.shape[-1])[take].to(pool.dtype)


# ------------------------------------------------------------- wrappers


def _check(q, pool, page_table, lengths):
    if q.dtype != torch.bfloat16 or pool.dtype != torch.bfloat16:
        raise ValueError("the latent attention kernel takes bf16 queries and "
                         "a bf16 pool")
    if q.shape[-1] != DK or pool.shape[-1] != DK or q.shape[-2] % HG:
        raise ValueError(f"the latent attention kernel takes {DK}-wide slots "
                         f"and heads in groups of {HG}, not q "
                         f"{tuple(q.shape)} over a pool {tuple(pool.shape)}")
    if pool.shape[1] != 1:
        raise ValueError("a latent pool has one head")
    for name, t in (("q", q), ("pool", pool), ("page_table", page_table),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("page_table and lengths are int32")


def _launch(q, fresh, pool, page_table, lengths, layer, out, ws, counters,
            T, splits, span, scale):
    from v2pe_tpu_torch.ops import _build

    lib = _build.load()
    B, _, H = q.shape[:3] if q.dim() == 4 else (q.shape[0], 1, q.shape[1])
    NP, ps = pool.shape[2], pool.shape[3]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.v2pe_mla_attention(
        ptr(q), ptr(fresh), ptr(pool), ptr(page_table), ptr(lengths),
        ptr(out), ptr(ws), ptr(counters), B, T, H, NP, ps,
        page_table.shape[1], layer, splits, span, ctypes.c_float(scale),
        _build.raw_stream(q.device.index))
    if err != 0:
        raise RuntimeError(f"v2pe_mla_attention failed: CUDA error {err}")


def mla_decode(q: torch.Tensor, fresh: torch.Tensor, pool: torch.Tensor,
               page_table: torch.Tensor, lengths: torch.Tensor, layer: int,
               scale: float, dv: int) -> torch.Tensor:
    """q (B, H, 576) absorbed queries of one token a row, fresh (B, 576)
    its latents -> (B, H, dv): stores ``fresh`` at slot ``lengths`` and
    attends slots 0..lengths. ``dv``: the latent's width."""
    if q.device.type != "cuda":
        return mla_decode_torch(q, fresh, pool, page_table, lengths, layer,
                                scale, dv)
    _check(q, pool, page_table, lengths)
    if dv != DV or fresh.dtype != torch.bfloat16 or not fresh.is_contiguous():
        raise ValueError("mla_decode: a contiguous bf16 (B, 576) latent and "
                         f"{DV} output dims")
    B, H = q.shape[:2]
    splits, span = decode_splits(B, H, page_table.shape[1], pool.shape[3])
    ws = counters = None
    if splits > 1:
        ws, counters = _scratch(q.device, B * (H // HG) * splits * HG
                                * (2 + DV), B * (H // HG))
    out = torch.empty((B, H, DV), dtype=q.dtype, device=q.device)
    _launch(q, fresh, pool, page_table, lengths, layer, out, ws, counters,
            1, splits, span, scale)
    LAUNCHES["mla_decode"] += 1
    return out


def mla_chunk(q: torch.Tensor, pool: torch.Tensor, page_table: torch.Tensor,
              lengths: torch.Tensor, layer: int, scale: float,
              dv: int) -> torch.Tensor:
    """q (B, T, H, 576) absorbed queries of a chunk whose latents are in
    the pool at slots lengths .. lengths + T - 1 -> (B, T, H, dv): token t
    attends slots 0 .. lengths + t."""
    if q.device.type != "cuda":
        return mla_chunk_torch(q, pool, page_table, lengths, layer, scale,
                               dv)
    _check(q, pool, page_table, lengths)
    if dv != DV:
        raise ValueError(f"mla_chunk: {DV} output dims")
    B, T, H = q.shape[:3]
    out = torch.empty((B, T, H, DV), dtype=q.dtype, device=q.device)
    _launch(q, None, pool, page_table, lengths, layer, out, None, None, T, 1,
            0, scale)
    LAUNCHES["mla_chunk"] += 1
    return out
