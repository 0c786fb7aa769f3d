"""Chunked prefill onto a (possibly nonempty) paged KV cache (port of
``v2pe_tpu/infer/chunked_prefill.py``).

A prompt chunk attends to the pages already in the pool through the paged
prefill kernel, merged by logsumexp with its own causal self-attention
(the flash kernel), and its k/v are scattered into fresh pages: turn N of
a chat costs attention of the new chunk over the history, with no
recomputation of the history's layers.

Usage::

    cache = PagedKVCache.zeros(...)
    logits, cache = chunked_prefill(llm, cfg, cache, ids_chunk1, pos1)
    logits, cache = chunked_prefill(llm, cfg, cache, ids_chunk2, pos2)
    # ... then decode with llm_forward(paged_cache=cache)
"""

from __future__ import annotations

from typing import Optional

import torch

from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.models import internlm2


@torch.inference_mode()
def chunked_prefill(llm, cfg, cache: pk.PagedKVCache,
                    input_ids: Optional[torch.Tensor] = None,
                    rope_pos_ids: Optional[torch.Tensor] = None,
                    inputs_embeds: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    return_hidden: bool = False):
    """Run one (B, S_chunk) chunk through the decoder against ``cache``:
    allocate pages, attend (pages + causal self), write the chunk's k/v
    into the pool in place, and advance lengths by each row's valid token
    count (segment 0 = right padding). rope_pos_ids default to integer
    positions after each row's length. Returns (logits or hidden states
    (B, S_chunk, ...), the updated cache)."""
    x = input_ids if input_ids is not None else inputs_embeds
    B, S = x.shape[:2]
    if segment_ids is not None:
        valid = (segment_ids != 0).sum(dim=1, dtype=torch.int32)
    else:
        valid = torch.full((B,), S, dtype=torch.int32,
                           device=cache.lengths.device)
    cache = pk.allocate_rows(cache, valid)
    out, cache = internlm2.llm_forward(
        llm, cfg, input_ids=input_ids, inputs_embeds=inputs_embeds,
        rope_pos_ids=rope_pos_ids, segment_ids=segment_ids,
        paged_cache=cache, paged_attend_cache=True,
        return_hidden=return_hidden)
    return out, pk.advance_lengths(cache, valid)
