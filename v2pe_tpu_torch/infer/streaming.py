"""Chunked streaming decode for serving (port of
``v2pe_tpu/infer/streaming.py``, dense or paged cache): prefill once, then
decode in chunks of ``chunk`` tokens, yielding each chunk's tokens as it
completes."""

from __future__ import annotations

from typing import Iterator, Optional

import dataclasses

import numpy as np
import torch

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.infer.generate import (GenerationConfig,
                                           _check_supported,
                                           _default_generator, _decode_step,
                                           _sample, paged_prefill_cache,
                                           prompt_embeds)
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.internlm2 import KVCache
from v2pe_tpu_torch.parallel.mesh import serving_mode


def _prefill(model, cfg: VLMConfig, gc: GenerationConfig, input_ids,
             rope_pos_ids, pixel_values, image_flags,
             img_context_token_id: int, max_total: int, generator,
             cache_mode: str = "dense", page_size: int = 128,
             kv_dtype=None):
    llm = model.llm
    heads = internlm2.local_kv_heads(llm, cfg.llm)
    embeds = prompt_embeds(model, cfg, input_ids, pixel_values, image_flags,
                           img_context_token_id)
    B, S = input_ids.shape
    if cache_mode == "paged":
        cache = paged_prefill_cache(cfg.llm, B, max_total, page_size,
                                    kv_dtype, embeds.dtype, embeds.device,
                                    kv_heads=heads)
        lens = torch.full((B,), S, dtype=torch.int32, device=embeds.device)
        cache = pk.allocate_rows(cache, lens)
        hidden, cache = internlm2.llm_forward(
            llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
            paged_cache=cache, return_hidden=True)
        cache = dataclasses.replace(cache, lengths=lens)
    else:
        cache = KVCache.zeros(cfg.llm, B, max_total, dtype=embeds.dtype,
                              device=embeds.device, kv_heads=heads)
        hidden, cache = internlm2.llm_forward(
            llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
            kv_cache=cache, return_hidden=True)
    last_logits = internlm2.head_logits(hidden[:, -1:],
                                        llm.output)[:, 0]
    return _sample(last_logits, gc, generator).to(torch.int32), cache


def _decode_chunk(model, cfg: VLMConfig, gc: GenerationConfig, cache, tok,
                  pos, done, generator, chunk: int):
    """``chunk`` decode steps; rows already done emit 0 and are not
    counted. Returns (cache, tok, pos, done, out (B, chunk), cnt (B,))."""
    eos = torch.tensor(gc.eos_token_ids, dtype=torch.int32, device=tok.device)
    B = tok.shape[0]
    out = torch.zeros((B, chunk), dtype=torch.int32, device=tok.device)
    cnt = torch.zeros((B,), dtype=torch.int32, device=tok.device)
    for i in range(chunk):
        nxt, cache = _decode_step(model.llm, cfg.llm, gc, cache, tok, pos,
                                  generator)
        nxt = torch.where(done, 0, nxt)
        out[:, i] = nxt
        cnt += (~done).to(torch.int32)
        done = done | torch.isin(nxt, eos)
        tok, pos = nxt, pos + 1.0
    return cache, tok, pos, done, out, cnt


@serving_mode
def stream_generate(model, cfg: VLMConfig, gc: GenerationConfig,
                    input_ids: np.ndarray,     # (1, S)
                    rope_pos_ids: np.ndarray,  # (1, S) float32
                    pixel_values, image_flags,
                    img_context_token_id: int, chunk: int = 8,
                    generator: Optional[torch.Generator] = None,
                    cache_mode: str = "dense", page_size: int = 128,
                    kv_dtype=None) -> Iterator[np.ndarray]:
    """Yields int32 token chunks until EOS or max_new_tokens."""
    _check_supported(gc, cache_mode, kv_dtype)
    device = model.llm.tok_embeddings.weight.device
    generator = _default_generator(device, generator)
    input_ids = torch.as_tensor(input_ids, device=device)
    rope_pos_ids = torch.as_tensor(rope_pos_ids, dtype=torch.float32,
                                   device=device)
    S = input_ids.shape[1]
    tok, cache = _prefill(model, cfg, gc, input_ids, rope_pos_ids,
                          torch.as_tensor(pixel_values),
                          torch.as_tensor(image_flags),
                          img_context_token_id, S + gc.max_new_tokens,
                          generator, cache_mode, page_size, kv_dtype)
    eos = set(gc.eos_token_ids)
    done = torch.tensor([int(tok[0]) in eos], device=device)
    if not bool(done[0]):
        yield tok.cpu().numpy()[:1]
    pos = rope_pos_ids[:, -1] + 1.0
    emitted = 1
    while emitted < gc.max_new_tokens and not bool(done[0]):
        n = min(chunk, gc.max_new_tokens - emitted)
        cache, tok, pos, done, out, cnt = _decode_chunk(
            model, cfg, gc, cache, tok, pos, done, generator, n)
        keep = out[0, :int(cnt[0])].cpu().numpy()
        emitted += n
        if len(keep):
            yield keep
        if len(keep) and int(keep[-1]) in eos:
            break
