"""Autoregressive generation (port of ``v2pe_tpu/infer/generate.py``) over
the dense KV cache or the paged one (``cache_mode="paged"``, with a bf16 or
int8 pool).

Prefill scatters the ViT features into the prompt, runs the decoder once
and fills a preallocated cache (or the pages it allocates); the decode loop
then runs one token per step on the host. Generated tokens take V2PE
positions at integer stride from the (possibly fractional) position of the
last prompt token.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from v2pe_tpu.core.config import VLMConfig
from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.models import internlm2, internvl_chat
from v2pe_tpu_torch.models.internlm2 import KVCache


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 256
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    eos_token_ids: Tuple[int, ...] = ()
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = False
    speculative_k: int = 0
    speculative_ngram: int = 3


def _sample(logits: torch.Tensor, gc: GenerationConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax (first maximal index), or a draw after temperature,
    top-k and top-p filtering."""
    if not gc.do_sample or gc.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / gc.temperature
    if gc.top_k > 0:
        kth = torch.topk(logits, gc.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if gc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < gc.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def _check_supported(gc: GenerationConfig, cache_mode: str,
                     kv_dtype=None) -> None:
    if cache_mode not in ("dense", "paged"):
        raise NotImplementedError(f"cache_mode={cache_mode!r}")
    if kv_dtype not in (None, "int8"):
        raise NotImplementedError(f"kv_dtype={kv_dtype!r}: the port has "
                                  f"bf16/fp32 and int8 pools")
    if gc.num_beams > 1:
        raise NotImplementedError("beam search is not ported yet")
    if gc.speculative_k > 0:
        raise NotImplementedError("speculative decoding is not ported yet")


def _default_generator(device, generator):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def prompt_embeds(model, cfg: VLMConfig, input_ids: torch.Tensor,
                  pixel_values: torch.Tensor, image_flags: torch.Tensor,
                  img_context_token_id: int) -> torch.Tensor:
    """Token embeddings with the ViT features in the <IMG_CONTEXT> slots.
    A prompt without such slots skips the ViT (the scatter would change
    nothing)."""
    embeds = model.llm.tok_embeddings(input_ids)
    if not bool((input_ids == img_context_token_id).any()):
        return embeds
    vit = internvl_chat.extract_feature(
        model, cfg, pixel_values.to(device=embeds.device, dtype=embeds.dtype))
    return internvl_chat.scatter_image_embeds(
        embeds, input_ids, vit, image_flags.to(embeds.device),
        img_context_token_id)


def paged_prefill_cache(lcfg, batch: int, max_len: int, page_size: int,
                        kv_dtype, dtype, device) -> pk.PagedKVCache:
    """An empty pool for ``batch`` rows of up to ``max_len`` tokens: each
    row's worst case plus the reserved null page."""
    MP = -(-max_len // page_size)
    return pk.PagedKVCache.zeros(lcfg, batch, batch * MP + 1, page_size, MP,
                                 dtype=dtype, kv_dtype=kv_dtype,
                                 device=device)


def _decode_step(llm, lcfg, gc, cache, tok, pos, generator, kv_valid=None):
    """One token per row at V2PE position ``pos``: (next tokens, cache). A
    paged cache gets its page for the token first (on the device) and its
    lengths advanced after."""
    emb = llm.tok_embeddings(tok)[:, None, :]
    if isinstance(cache, pk.PagedKVCache):
        cache = pk.allocate_rows(cache, torch.ones_like(cache.lengths))
        logits, cache = internlm2.llm_forward(
            llm, lcfg, inputs_embeds=emb, rope_pos_ids=pos[:, None],
            paged_cache=cache)
        cache = pk.advance_lengths(cache, 1)
    else:
        logits, cache = internlm2.llm_forward(
            llm, lcfg, inputs_embeds=emb, rope_pos_ids=pos[:, None],
            kv_cache=cache, kv_valid=kv_valid)
    return _sample(logits[:, -1], gc, generator).to(torch.int32), cache


@torch.inference_mode()
def generate(model, cfg: VLMConfig, gc: GenerationConfig,
             input_ids: torch.Tensor,       # (B, S) int, right-padded
             prompt_lengths: torch.Tensor,  # (B,) true prompt lengths
             rope_pos_ids: torch.Tensor,    # (B, S) float32 V2PE positions
             pixel_values: torch.Tensor,    # (T, 3, sz, sz)
             image_flags: torch.Tensor,     # (T,)
             img_context_token_id: int,
             generator: Optional[torch.Generator] = None,
             cache_mode: str = "dense", page_size: int = 128,
             kv_dtype: Optional[str] = None):
    """Greedy or sampled decode. Returns (tokens (B, max_new) int32, steps,
    gen_lens (B,)): gen_lens[i] counts row i's generated tokens including
    its stop token; later slots of a finished row are 0."""
    _check_supported(gc, cache_mode, kv_dtype)
    llm = model.llm
    device = llm.tok_embeddings.weight.device
    input_ids = input_ids.to(device)
    prompt_lengths = prompt_lengths.to(device)
    rope_pos_ids = rope_pos_ids.to(device=device, dtype=torch.float32)
    generator = _default_generator(device, generator)
    B, S = input_ids.shape
    max_len = S + gc.max_new_tokens

    embeds = prompt_embeds(model, cfg, input_ids, pixel_values, image_flags,
                           img_context_token_id)
    seg = (torch.arange(S, device=device)[None] < prompt_lengths[:, None]
           ).to(torch.int32)
    slot = torch.arange(max_len, device=device)[None]

    def kv_valid_at(t: int) -> torch.Tensor:
        """Valid cache slots once t decode tokens are written: the row's
        prompt, then the decode slots from S on."""
        return (slot < prompt_lengths[:, None]) | ((slot >= S) & (slot < S + t))

    if cache_mode == "paged":
        cache = paged_prefill_cache(cfg.llm, B, max_len, page_size, kv_dtype,
                                    embeds.dtype, device)
        lengths = prompt_lengths.to(torch.int32)
        cache = pk.allocate_rows(cache, lengths)
        hidden, cache = internlm2.llm_forward(
            llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
            segment_ids=seg, paged_cache=cache, return_hidden=True)
        cache = dataclasses.replace(cache, lengths=lengths)
        kv_valid_fn = None
    else:
        cache = KVCache.zeros(cfg.llm, B, max_len, dtype=embeds.dtype,
                              device=device)
        hidden, cache = internlm2.llm_forward(
            llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
            segment_ids=seg, kv_cache=cache, kv_valid=kv_valid_at(0),
            return_hidden=True)
        kv_valid_fn = kv_valid_at
    last = (prompt_lengths - 1).long()
    last_hidden = hidden[torch.arange(B, device=device), last][:, None]
    last_logits = internlm2.head_logits(last_hidden, llm.output.weight)[:, 0]
    last_pos = rope_pos_ids[torch.arange(B, device=device), last]
    out, steps, lens, _ = decode_from_logits(
        llm, cfg.llm, gc, cache, last_logits, last_pos, generator,
        kv_valid_at=kv_valid_fn)
    return out, steps, lens


def decode_from_logits(llm, lcfg, gc: GenerationConfig, cache,
                       last_logits: torch.Tensor, last_pos: torch.Tensor,
                       generator: Optional[torch.Generator], *,
                       kv_valid_at: Optional[Callable] = None):
    """Sample token 0 from the prefill's last logits, then decode one token
    per step over ``cache`` (a dense KVCache, with its ``kv_valid_at(t)``
    mask function, or a PagedKVCache) until every row has stopped or
    max_new_tokens. Returns (out (B, max_new) int32, steps, lens (B,),
    cache)."""
    B = last_logits.shape[0]
    device = last_logits.device
    eos = torch.tensor(gc.eos_token_ids, dtype=torch.int32, device=device)
    tok = _sample(last_logits, gc, generator).to(torch.int32)
    out = torch.zeros((B, gc.max_new_tokens), dtype=torch.int32,
                      device=device)
    out[:, 0] = tok
    done = torch.isin(tok, eos)
    lens = torch.ones((B,), dtype=torch.int32, device=device)
    pos = last_pos + 1.0
    t = 1
    while t < gc.max_new_tokens and not bool(done.all()):
        kv_valid = kv_valid_at(t) if kv_valid_at is not None else None
        nxt, cache = _decode_step(llm, lcfg, gc, cache, tok, pos, generator,
                                  kv_valid)
        nxt = torch.where(done, 0, nxt)
        out[:, t] = nxt
        lens += (~done).to(torch.int32)
        done = done | torch.isin(nxt, eos)
        tok, pos, t = nxt, pos + 1.0, t + 1
    return out, t, lens, cache
