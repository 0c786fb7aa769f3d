"""Stateful multi-turn chat over a persistent paged KV cache (port of
``v2pe_tpu/infer/session.py``).

A :class:`ChatSession` keeps the page pool alive across turns. Each
``send()`` tokenizes the whole conversation, keeps the prefix already in the
cache, and runs only the new suffix through
:func:`~v2pe_tpu_torch.infer.chunked_prefill.chunked_prefill` (the paged
prefill kernel over the history, merged with the suffix's causal
self-attention), then decodes in-session through the paged decode kernels.

Tokenizers need not be prefix-stable, so the kept prefix is the longest
common prefix of this turn's tokens and the last turn's; the cache rolls
back to it. Generated tokens are rolled back after each turn (lengths reset
to the prompt end): the next turn re-embeds the response from the template
text, so the cache always holds exactly the tokenization of the running
template prefix. Suffixes are right-padded to a multiple of
``chunk_multiple`` (segment-0 padding), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from v2pe_tpu.positional import build_v2pe_pos_ids
from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
from v2pe_tpu_torch.infer.generate import (GenerationConfig,
                                           _default_generator,
                                           decode_from_logits, prompt_embeds)
from v2pe_tpu_torch.models import internlm2


class ChatSession:
    """One conversation bound to one persistent paged cache (batch 1)."""

    def __init__(self, chat_model, max_len: int = 32768,
                 page_size: int = 512, kv_dtype=None,
                 chunk_multiple: int = 256):
        self.m = chat_model
        self.cfg = chat_model.cfg
        self.max_len = max_len
        self.chunk_multiple = chunk_multiple
        emb = chat_model.model.llm.tok_embeddings.weight
        MP = -(-max_len // page_size)
        self.cache = pk.PagedKVCache.zeros(
            self.cfg.llm, 1, MP + 1, page_size, MP, dtype=emb.dtype,
            kv_dtype=kv_dtype, device=emb.device)
        self.consumed = 0  # tokens of the template prefix in the cache
        self.last_logits = None  # (1, V) fp32 logits of the last turn's
        # first generated token
        self.history = []
        self.num_patches_list = []
        self._prev_ids = np.zeros(0, np.int64)

    def _set_length(self, n: int) -> None:
        self.cache = dataclasses.replace(
            self.cache, lengths=torch.full_like(self.cache.lengths, n))

    @torch.inference_mode()
    def send(self, pixel_values, question: str,
             generation_config: Optional[GenerationConfig] = None) -> str:
        """One turn: ``pixel_values`` are the NEW image's tiles (from
        ``chat_model.load_pixels``) or None for text only."""
        gc = generation_config or GenerationConfig()
        if gc.speculative_k > 0:
            raise NotImplementedError("speculative decoding is not ported "
                                      "yet")
        m = self.m
        new_patches = [pixel_values.shape[0]] if pixel_values is not None \
            else []
        if pixel_values is not None and "<image>" not in question:
            question = "<image>\n" + question
        npl = self.num_patches_list + new_patches
        query = m.build_query(question, npl, self.history)
        ids = np.asarray(m.tokenizer(query)["input_ids"], np.int64)
        version = self.cfg.rope_pos_id_version
        if npl and version != "default":
            pos = build_v2pe_pos_ids(
                ids, np.ones_like(ids), npl,
                img_start_id=m.img_start_id, img_end_id=m.img_end_id,
                num_image_token=self.cfg.num_image_token,
                version=version, stride=self.cfg.rope_pos_id_stride)
        else:
            pos = np.arange(len(ids), dtype=np.float32)
        if len(ids) + gc.max_new_tokens > self.max_len:
            raise ValueError("session max_len exceeded: prompt + "
                             "max_new_tokens must fit the pool")
        # roll the cache back to the longest common prefix with last turn
        n = min(self.consumed, len(ids), len(self._prev_ids))
        eq = ids[:n] == self._prev_ids[:n]
        common = n if eq.all() else int(eq.argmin())
        if common < self.consumed:
            self.consumed = common
            self._set_length(common)
        suf_ids = ids[self.consumed:]
        suf_pos = pos[self.consumed:].astype(np.float32)
        S = len(suf_ids)
        Sp = -(-max(S, 1) // self.chunk_multiple) * self.chunk_multiple
        pad = Sp - S

        llm = m.model.llm
        dev = llm.tok_embeddings.weight.device
        sids = torch.as_tensor(np.pad(suf_ids, (0, pad))[None], device=dev)
        spos = torch.as_tensor(np.pad(suf_pos, (0, pad))[None], device=dev)
        seg = torch.as_tensor(np.pad(np.ones(S, np.int32), (0, pad))[None],
                              device=dev)
        if pixel_values is not None:
            embeds = prompt_embeds(
                m.model, self.cfg, sids, torch.as_tensor(pixel_values),
                torch.ones((pixel_values.shape[0],), dtype=torch.int32),
                m.img_context_token_id)
        else:
            embeds = llm.tok_embeddings(sids)
        hidden, self.cache = chunked_prefill(
            llm, self.cfg.llm, self.cache, inputs_embeds=embeds,
            rope_pos_ids=spos, segment_ids=seg, return_hidden=True)
        last_logits = internlm2.head_logits(hidden[:, S - 1],
                                            llm.output.weight)
        self.last_logits = last_logits

        stop_ids = tuple(m.conv_template.stop_token_ids) or \
            (self.cfg.llm.eos_token_id,)
        gc = dataclasses.replace(gc, eos_token_ids=stop_ids)
        last_pos = torch.tensor([float(suf_pos[-1])], dtype=torch.float32,
                                device=dev)
        out, _, lens, self.cache = decode_from_logits(
            llm, self.cfg.llm, gc, self.cache, last_logits, last_pos,
            _default_generator(dev, None))
        # roll the generated tokens back out of the cache (see module doc)
        self._set_length(len(ids))

        response = m._decode(out[0].cpu().numpy(), int(lens[0]))
        self.history.append((question, response))
        self.num_patches_list = npl
        self.consumed = len(ids)
        self._prev_ids = ids
        return response
