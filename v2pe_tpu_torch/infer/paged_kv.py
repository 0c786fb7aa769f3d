"""Paged KV cache (port of ``v2pe_tpu/infer/paged_kv.py``).

One physical pool, (L, Hkv, n_pages, page_size, hd), shared by all rows of
a batch through per-row page tables, so ragged rows share memory and a row
grows one page at a time. A quantized pool (int8, or int4 as packed bytes
of shape (..., page_size, hd/2): ``ops/paged_attention.pack_int4``) carries
fp32 scales per (layer, head, token) in (L, Hkv, n_pages, 1, page_size).
Page 0 is the reserved null page: the allocator never hands it out.

A latent pool (:meth:`PagedKVCache.latents`, the DeepSeek-V3 decoder's
latent attention) is one tensor, (L, 1, n_pages, page_size, kv_lora_rank +
qk_rope_head_dim), in ``k_pages``: each slot a token's latents and its
rotated rotary key, which every head reads; ``v_pages`` is None (the values
are the latents). The page tables, the allocation and the lengths are the
same; ``ops/mla_attention.py`` writes and reads it.

Sequence sharding (``n_shards > 1``, JAX's pool over the ``seq`` axis):
shard d owns the global pages [d NP/n, (d+1) NP/n), its local page 0 is its
null page, and :func:`allocate_rows` places a row's page at table slot s
on shard s % n, so a row's pages spread evenly. On one card the pool holds
every shard (``shard`` None); across processes each rank's pool holds only
its shard's NP/n pages (``shard`` = its ``seq`` coordinate), and the writes
below touch only the slots it owns. The page table and the lengths are
global, the same on every rank. Under a ``tensor`` axis the pool holds a
rank's kv heads (``kv_heads``).

The port mutates the pool in place (the JAX package donates it to each jit
call instead): every write below indexes into the pool tensors and returns
the same tensors. Allocation and lengths stay tensors on the pool's device,
so a decode step needs no host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from v2pe_tpu_torch.core.config import LLMConfig
from v2pe_tpu_torch.ops.paged_attention import (pack_int4, quantize_kv,
                                                unpack_int4)


@dataclasses.dataclass
class PagedKVCache:
    """Physical pool and page tables.

    k_pages/v_pages: (L, Hkv, n_pages, page_size, hd), or hd/2 packed bytes
        for an int4 pool
    page_table: (B, max_pages_per_row) int32, global page id or -1
    lengths: (B,) int32, tokens written per row
    next_page: (n_shards,) int32, the shards' bump heads (shard d starts
        at its local page 1, global d NP/n + 1)
    k_scales/v_scales: (L, Hkv, n_pages, 1, page_size) fp32, quantized
        pools only
    kv_bits: 8 or 4, the width of a quantized pool's codes
    shard: None when the pool holds every page; across processes, the
        shard whose NP/n pages it holds
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    next_page: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None
    kv_bits: int = 8
    shard: Optional[int] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def n_shards(self) -> int:
        return self.next_page.shape[0]

    @property
    def n_pages(self) -> int:
        """Global pages (this pool's times the shards when it holds one)."""
        held = self.k_pages.shape[2]
        return held if self.shard is None else held * self.n_shards

    @property
    def first_page(self) -> int:
        """The global id of this pool's page 0."""
        return 0 if self.shard is None else self.shard * self.k_pages.shape[2]

    @property
    def max_pages_per_row(self) -> int:
        return self.page_table.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @staticmethod
    def zeros(cfg: LLMConfig, batch: int, n_pages: int, page_size: int,
              max_pages_per_row: int, dtype=torch.bfloat16,
              n_shards: int = 1, kv_dtype=None, device=None,
              shard: Optional[int] = None,
              kv_heads: Optional[int] = None) -> "PagedKVCache":
        """An empty pool of ``n_pages`` global pages over ``n_shards``;
        ``shard``: hold only that shard's pages; ``kv_heads``: the heads
        held (default all)."""
        if n_shards < 1 or n_pages % n_shards:
            raise ValueError(f"{n_pages} pages do not split over {n_shards} "
                             f"shards")
        if shard is not None and not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} of {n_shards}")
        held = n_pages if shard is None else n_pages // n_shards
        quant = kv_dtype in ("int8", "int4", torch.int8)
        bits = 4 if kv_dtype == "int4" else 8
        if quant:
            dtype = torch.int8
        elif kv_dtype is not None:
            dtype = kv_dtype
        if bits == 4 and cfg.head_dim % 2:
            raise ValueError("an int4 pool packs two dims of a head per byte: "
                             "the head dim must be even")
        shape = (cfg.num_hidden_layers, kv_heads or cfg.num_key_value_heads,
                 held, page_size,
                 cfg.head_dim // 2 if bits == 4 else cfg.head_dim)

        def scales():
            return torch.zeros(shape[:3] + (1, page_size),
                               dtype=torch.float32, device=device) \
                if quant else None

        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            page_table=torch.full((batch, max_pages_per_row), -1,
                                  dtype=torch.int32, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            next_page=(torch.arange(n_shards, dtype=torch.int32,
                                    device=device) * (n_pages // n_shards)
                       + 1).to(torch.int32),
            k_scales=scales(), v_scales=scales(), kv_bits=bits, shard=shard)

    @staticmethod
    def latents(cfg, batch: int, n_pages: int, page_size: int,
                max_pages_per_row: int, dtype=torch.bfloat16,
                device=None) -> "PagedKVCache":
        """An empty latent pool for the MLA decoder of ``cfg`` (an
        ``MLAConfig``): one shard, unquantized."""
        shape = (cfg.num_hidden_layers, 1, n_pages, page_size, cfg.latent_dim)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=None,
            page_table=torch.full((batch, max_pages_per_row), -1,
                                  dtype=torch.int32, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            next_page=torch.ones((1,), dtype=torch.int32, device=device))


def allocate_rows(cache: PagedKVCache, new_lengths: torch.Tensor
                  ) -> PagedKVCache:
    """Extend each row's page table to cover ``lengths + new_lengths``
    tokens with freshly bumped pages. The page at table slot s comes from
    shard s % n_shards' head, in row-major order within each shard (one
    shard: row-major from page 1). Idempotent: slots that already hold a
    page keep it (a session that rolls tokens back by resetting lengths
    reuses its pages)."""
    ps = cache.page_size
    B, MP = cache.page_table.shape
    n = cache.n_shards
    lengths = cache.lengths.long()
    need = -(-(lengths + new_lengths.long()) // ps)
    have = -(-lengths // ps)
    slot = torch.arange(MP, device=lengths.device)[None]
    take = (slot >= have[:, None]) & (slot < need[:, None]) \
        & (cache.page_table == -1)
    flat = take.reshape(-1).to(torch.int32)
    shard = (slot % n).expand(B, MP).reshape(-1)
    rank = torch.zeros_like(flat)
    counts = []
    for d in range(n):
        sel = flat * (shard == d)
        rank += torch.where(shard == d,
                            torch.cumsum(sel, 0, dtype=torch.int32) - sel, 0)
        counts.append(sel.sum(dtype=torch.int32))
    new = (cache.next_page[shard] + rank).reshape(B, MP)
    table = torch.where(take, new, cache.page_table)
    return dataclasses.replace(
        cache, page_table=table.to(torch.int32),
        next_page=cache.next_page + torch.stack(counts))


def _flat(pages: torch.Tensor) -> torch.Tensor:
    """(L, Hkv, NP*ps, hd) view of a value pool: token slot page*ps +
    offset."""
    L, Hkv, NP, ps, hd = pages.shape
    return pages.view(L, Hkv, NP * ps, hd)


def _flat_scales(scales: torch.Tensor) -> torch.Tensor:
    """(L, Hkv, NP*ps) view of a (L, Hkv, NP, 1, ps) scale pool."""
    L, Hkv, NP, _, ps = scales.shape
    return scales.view(L, Hkv, NP * ps)


def token_slots(cache: PagedKVCache, T: int,
                valid: Optional[torch.Tensor] = None):
    """Where T tokens per row go, at each row's current length: (flat slot
    page*ps + offset of every written token (n,), (B, T) mask of the
    written ones). A token is written iff its page is allocated, in this
    pool (a rank's shard: at the page's local id) and, when given,
    ``valid`` (B, T) holds. Reads the mask back to the host once."""
    ps = cache.page_size
    dev = cache.lengths.device
    pos = cache.lengths.long()[:, None] + torch.arange(T, device=dev)[None]
    page_slot = torch.clamp(pos // ps, max=cache.max_pages_per_row - 1)
    phys = torch.gather(cache.page_table.long(), 1, page_slot)   # (B, T)
    mask = phys >= 0
    if cache.shard is not None:
        phys = phys - cache.first_page
        mask &= (phys >= 0) & (phys < cache.k_pages.shape[2])
    if valid is not None:
        mask &= valid.to(dev)
    return (phys * ps + pos % ps)[mask], mask


def scatter_layers(cache: PagedKVCache, layers: slice, k_new: torch.Tensor,
                   v_new: torch.Tensor, slots) -> None:
    """Write (L', B, T, Hkv, hd) k/v (quantized, and packed for an int4
    pool) into the pool layers ``layers`` at ``slots`` from
    :func:`token_slots`, in place."""
    idx, mask = slots
    if cache.quantized:
        k_new, ks = quantize_kv(k_new, cache.kv_bits)
        v_new, vs = quantize_kv(v_new, cache.kv_bits)
        if cache.kv_bits == 4:
            k_new, v_new = pack_int4(k_new), pack_int4(v_new)
        for pool, s in ((cache.k_scales, ks), (cache.v_scales, vs)):
            # (L', B, T, Hkv, 1) -> (L', Hkv, n)
            _flat_scales(pool)[layers, :, idx] = \
                s[..., 0][:, mask].transpose(1, 2)
    for pool, x in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        # (L', B, T, Hkv, hd) -> (L', Hkv, n, hd)
        _flat(pool)[layers, :, idx] = \
            x[:, mask].transpose(1, 2).to(pool.dtype)


def write_all_layers(cache: PagedKVCache, k_new: torch.Tensor,
                     v_new: torch.Tensor,
                     valid_t: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Write (L, B, T, Hkv, hd) k/v at each row's current length, all
    layers at once (pages must already be allocated; lengths are not
    advanced). valid_t (B,): valid tokens per row among the T."""
    T = k_new.shape[2]
    valid = None if valid_t is None else \
        torch.arange(T, device=valid_t.device)[None] < valid_t[:, None]
    scatter_layers(cache, slice(None), k_new, v_new,
                   token_slots(cache, T, valid))
    return cache


def write_tokens(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> PagedKVCache:
    """Single-layer write of (B, T, Hkv, hd) (test convenience)."""
    scatter_layers(cache, slice(layer, layer + 1), k_new[None], v_new[None],
                   token_slots(cache, k_new.shape[1]))
    return cache


def gather_row_kv(cache: PagedKVCache, layer: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, max_len, Hkv, hd) k/v of ``layer`` read through the page tables
    (fp32, dequantized for a quantized pool) and the (B, max_len) validity
    mask. Test path only: the kernels read pages directly."""
    B, MP = cache.page_table.shape
    ps = cache.page_size
    phys = cache.page_table.clamp_min(0).long()
    k = cache.k_pages[layer][:, phys]               # (Hkv, B, MP, ps, hd)
    v = cache.v_pages[layer][:, phys]
    if cache.quantized:
        if cache.kv_bits == 4:
            k, v = unpack_int4(k), unpack_int4(v)
        k = k.float() * cache.k_scales[layer][:, phys, 0][..., None]
        v = v.float() * cache.v_scales[layer][:, phys, 0][..., None]
    Hkv, hd = k.shape[0], k.shape[-1]
    k = k.permute(1, 2, 3, 0, 4).reshape(B, MP * ps, Hkv, hd)
    v = v.permute(1, 2, 3, 0, 4).reshape(B, MP * ps, Hkv, hd)
    pos = torch.arange(MP * ps, device=phys.device)[None]
    return k, v, pos < cache.lengths[:, None]


def pool_shards():
    """(shards of a new pool's page axis, the shard this process holds or
    None) under the current ``ShardingContext``: where every paged entry
    point reads how to lay out its pool."""
    from v2pe_tpu_torch.parallel import context as pctx

    ctx = pctx.current()
    if ctx is None:
        return 1, None
    return ctx.pool_shards, ctx.pool_shard


def shard_views(cache: PagedKVCache, fresh: bool = False):
    """The sequence shards' views of ``cache`` that this process runs
    (``ops/paged_attention.shard_views``), or None for one shard."""
    if cache.n_shards == 1:
        return None
    from v2pe_tpu_torch.ops.paged_attention import shard_views as views

    return views(cache.page_table, cache.lengths, cache.n_shards,
                 cache.n_pages, cache.page_size, held=cache.shard,
                 fresh=fresh)


def advance_lengths(cache: PagedKVCache, t) -> PagedKVCache:
    return dataclasses.replace(cache, lengths=cache.lengths + t)
