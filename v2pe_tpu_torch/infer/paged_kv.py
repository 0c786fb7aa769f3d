"""Paged KV cache (port of ``v2pe_tpu/infer/paged_kv.py``).

One physical pool, (L, Hkv, n_pages, page_size, hd), shared by all rows of
a batch through per-row page tables, so ragged rows share memory and a row
grows one page at a time. An int8 pool carries fp32 scales per (layer,
head, token) in (L, Hkv, n_pages, 1, page_size). Page 0 is the reserved
null page: the allocator never hands it out.

The port mutates the pool in place (the JAX package donates it to each jit
call instead): every write below indexes into the pool tensors and returns
the same tensors. Allocation and lengths stay tensors on the pool's device,
so a decode step needs no host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from v2pe_tpu.core.config import LLMConfig
from v2pe_tpu_torch.ops.paged_attention import quantize_kv

@dataclasses.dataclass
class PagedKVCache:
    """Physical pool and page tables.

    k_pages/v_pages: (L, Hkv, n_pages, page_size, hd)
    page_table: (B, max_pages_per_row) int32, physical page id or -1
    lengths: (B,) int32, tokens written per row
    next_page: (1,) int32, the bump allocator's head (starts at page 1)
    k_scales/v_scales: (L, Hkv, n_pages, 1, page_size) fp32, int8 pools only
    """

    k_pages: torch.Tensor
    v_pages: torch.Tensor
    page_table: torch.Tensor
    lengths: torch.Tensor
    next_page: torch.Tensor
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def max_pages_per_row(self) -> int:
        return self.page_table.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @staticmethod
    def zeros(cfg: LLMConfig, batch: int, n_pages: int, page_size: int,
              max_pages_per_row: int, dtype=torch.bfloat16,
              n_shards: int = 1, kv_dtype=None, device=None
              ) -> "PagedKVCache":
        if n_shards != 1:
            raise NotImplementedError("a sequence-sharded pool belongs to the "
                                      "multi-GPU slice")
        if kv_dtype in ("int4", "torch.int4"):
            raise NotImplementedError("int4 KV needs a nibble-packed pool "
                                      "layout of its own")
        quant = kv_dtype in ("int8", torch.int8)
        if quant:
            dtype = torch.int8
        elif kv_dtype is not None:
            dtype = kv_dtype
        shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, n_pages,
                 page_size, cfg.head_dim)

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
            next_page=torch.ones((1,), dtype=torch.int32, device=device),
            k_scales=scales(), v_scales=scales())


def allocate_rows(cache: PagedKVCache, new_lengths: torch.Tensor
                  ) -> PagedKVCache:
    """Extend each row's page table to cover ``lengths + new_lengths``
    tokens with freshly bumped pages, in row-major order. Idempotent: slots
    that already hold a page keep it (a session that rolls tokens back by
    resetting lengths reuses its pages)."""
    ps = cache.page_size
    B, MP = cache.page_table.shape
    lengths = cache.lengths.long()
    need = -(-(lengths + new_lengths.long()) // ps)
    have = -(-lengths // ps)
    slot = torch.arange(MP, device=lengths.device)[None]
    take = (slot >= have[:, None]) & (slot < need[:, None]) \
        & (cache.page_table == -1)
    flat = take.reshape(-1).to(torch.int32)
    rank = (torch.cumsum(flat, 0, dtype=torch.int32) - flat).reshape(B, MP)
    table = torch.where(take, cache.next_page + rank, cache.page_table)
    return dataclasses.replace(
        cache, page_table=table.to(torch.int32),
        next_page=cache.next_page + flat.sum(dtype=torch.int32))


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
    written ones). A token is written iff its page is allocated and, when
    given, ``valid`` (B, T) holds. Reads the mask back to the host once."""
    ps = cache.page_size
    dev = cache.lengths.device
    pos = cache.lengths.long()[:, None] + torch.arange(T, device=dev)[None]
    page_slot = torch.clamp(pos // ps, max=cache.max_pages_per_row - 1)
    phys = torch.gather(cache.page_table.long(), 1, page_slot)   # (B, T)
    mask = phys >= 0
    if valid is not None:
        mask &= valid.to(dev)
    return (phys * ps + pos % ps)[mask], mask


def scatter_layers(cache: PagedKVCache, layers: slice, k_new: torch.Tensor,
                   v_new: torch.Tensor, slots) -> None:
    """Write (L', B, T, Hkv, hd) k/v (quantized for an int8 pool) into the
    pool layers ``layers`` at ``slots`` from :func:`token_slots`, in
    place."""
    idx, mask = slots
    if cache.quantized:
        k_new, ks = quantize_kv(k_new)
        v_new, vs = quantize_kv(v_new)
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
    (fp32, dequantized for an int8 pool) and the (B, max_len) validity
    mask. Test path only: the kernels read pages directly."""
    B, MP = cache.page_table.shape
    ps = cache.page_size
    phys = cache.page_table.clamp_min(0).long()
    k = cache.k_pages[layer][:, phys]               # (Hkv, B, MP, ps, hd)
    v = cache.v_pages[layer][:, phys]
    if cache.quantized:
        k = k.float() * cache.k_scales[layer][:, phys, 0][..., None]
        v = v.float() * cache.v_scales[layer][:, phys, 0][..., None]
    Hkv, hd = k.shape[0], k.shape[-1]
    k = k.permute(1, 2, 3, 0, 4).reshape(B, MP * ps, Hkv, hd)
    v = v.permute(1, 2, 3, 0, 4).reshape(B, MP * ps, Hkv, hd)
    pos = torch.arange(MP * ps, device=phys.device)[None]
    return k, v, pos < cache.lengths[:, None]


def advance_lengths(cache: PagedKVCache, t) -> PagedKVCache:
    return dataclasses.replace(cache, lengths=cache.lengths + t)
