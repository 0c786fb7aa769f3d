"""Beam-search decoding (port of ``v2pe_tpu/infer/beam.py``).

The semantics of HF ``generate(num_beams=K)`` with ``BeamSearchScorer``:

* per step: expand each live beam over the vocab and take the top ``2K``
  candidates of the cumulative log-probability; EOS candidates ranked below
  ``K`` retire into the hypothesis pool with score ``sum_logprobs /
  generated_len ** length_penalty``; the first ``K`` non-EOS candidates, in
  rank order, become the next beams;
* a row is done when all ``K`` hypothesis slots are filled and (unless
  ``early_stopping``) the worst kept score is at least the best still
  reachable ``max_cum / cur_len ** length_penalty``;
* finalize: still-open beams join the pool and the best hypothesis is
  returned.

Positions are carried per ROW, so every beam of a row shares its V2PE
positions and continues at integer stride from the fractional prompt
maximum, as greedy decode does. The KV cache is the dense preallocated
cache tiled to ``B * K`` rows and gathered by parent beam each step. The
JAX ``lax.while_loop`` is a Python loop whose test reads one value back per
step.
"""

from __future__ import annotations

import dataclasses

import torch

from v2pe_tpu_torch.infer.generate import prompt_embeds
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.internlm2 import KVCache
from v2pe_tpu_torch.parallel.mesh import serving_mode

NEG = -1e9


@serving_mode
def beam_generate(model, cfg, gc, input_ids: torch.Tensor,
                  prompt_lengths: torch.Tensor, rope_pos_ids: torch.Tensor,
                  pixel_values: torch.Tensor, image_flags: torch.Tensor,
                  img_context_token_id: int):
    """Returns (tokens (B, max_new) int32, lengths (B,) int32): the best
    hypothesis per row, its stop token excluded from the length. Matches
    greedy ``generate`` token for token at ``num_beams=1``."""
    K, lp = gc.num_beams, gc.length_penalty
    llm = model.llm
    dev = llm.tok_embeddings.weight.device
    input_ids = input_ids.to(dev)
    prompt_lengths = prompt_lengths.to(dev)
    rope_pos_ids = rope_pos_ids.to(device=dev, dtype=torch.float32)
    B, S = input_ids.shape
    max_new = gc.max_new_tokens
    max_len = S + max_new
    V = cfg.llm.vocab_size
    eos = torch.tensor(gc.eos_token_ids, dtype=torch.int32, device=dev)
    rowi = torch.arange(B, device=dev)

    def norm(n: int) -> torch.Tensor:
        """n ** length_penalty in fp32, as a tensor (a division by a tensor
        is exact on the card too)."""
        return torch.full((), float(n), device=dev) ** lp

    # ---- prefill, as generate()
    embeds = prompt_embeds(model, cfg, input_ids, pixel_values, image_flags,
                           img_context_token_id)
    seg = (torch.arange(S, device=dev)[None] < prompt_lengths[:, None]
           ).to(torch.int32)
    slot = torch.arange(max_len, device=dev)[None]
    cache = KVCache.zeros(cfg.llm, B, max_len, dtype=embeds.dtype, device=dev,
                          kv_heads=internlm2.local_kv_heads(llm, cfg.llm))
    hidden, cache = internlm2.llm_forward(
        llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
        segment_ids=seg, kv_cache=cache,
        kv_valid=slot < prompt_lengths[:, None], return_hidden=True)
    last = (prompt_lengths - 1).long()
    last_logits = internlm2.head_logits(hidden[rowi, last][:, None],
                                        llm.output)[:, 0]        # (B, V)
    pos = rope_pos_ids[rowi, last] + 1.0                          # (B,)

    # tile the cache to B*K beam rows (row b beam k -> b*K + k)
    cache = dataclasses.replace(
        cache, k=cache.k.repeat_interleave(K, dim=1),
        v=cache.v.repeat_interleave(K, dim=1))
    plens_bk = prompt_lengths.repeat_interleave(K)

    def kv_valid_at(t: int):
        return (slot < plens_bk[:, None]) | ((slot >= S) & (slot < S + t))

    def offer(hyp, score, tokens, length: int):
        """BeamHypotheses.add for one candidate per row: it replaces the
        row's worst hypothesis when it scores higher."""
        hyp_s, hyp_t, hyp_l = hyp
        worst = torch.argmin(hyp_s, dim=1)
        better = score > hyp_s[rowi, worst]
        hyp_s[rowi, worst] = torch.where(better, score, hyp_s[rowi, worst])
        hyp_t[rowi, worst] = torch.where(better[:, None], tokens,
                                         hyp_t[rowi, worst])
        hyp_l[rowi, worst] = torch.where(better, length, hyp_l[rowi, worst])

    def process(t: int, logp, scores, hyp, out):
        """One BeamSearchScorer.process step. logp (B, K, V) fresh token
        log-probs; t tokens were generated before this step."""
        cand = (scores[:, :, None] + logp).reshape(B, K * V)
        top_s, top_i = torch.topk(cand, 2 * K, dim=1)             # (B, 2K)
        tok = (top_i % V).to(torch.int32)
        parent = top_i // V
        is_eos = torch.isin(tok, eos)
        rank = torch.arange(2 * K, device=dev).expand(B, 2 * K)
        # EOS candidates ranked < K retire into the pool, normalized by the
        # GENERATED length t + 1 (the eos counted, the prompt not)
        offered = is_eos & (rank < K)
        offer_score = torch.where(offered, top_s / norm(t + 1),
                                  float("-inf"))
        for i in range(K):
            offer(hyp, offer_score[:, i], out[rowi, parent[:, i]], t)
        # the next K beams: the first K non-EOS candidates in rank order
        order = torch.argsort(torch.where(is_eos, 2 * K + rank, rank), dim=1,
                              stable=True)
        pick = order[:, :K]
        new_parent = torch.gather(parent, 1, pick)
        out = torch.gather(out, 1, new_parent[:, :, None].expand(-1, -1,
                                                                 max_new))
        new_tok = torch.gather(tok, 1, pick)
        out[:, :, t] = new_tok
        return (torch.gather(top_s, 1, pick), new_tok, new_parent, out,
                top_s.max(dim=1).values)

    hyp = (torch.full((B, K), float("-inf"), device=dev),
           torch.zeros((B, K, max_new), dtype=torch.int32, device=dev),
           torch.zeros((B, K), dtype=torch.int32, device=dev))
    init_scores = torch.full((B, K), NEG, device=dev)
    init_scores[:, 0] = 0.0
    logp0 = torch.log_softmax(last_logits, dim=-1)
    scores, tok, parent, out, best_cum = process(
        0, logp0[:, None].expand(B, K, V), init_scores, hyp,
        torch.zeros((B, K, max_new), dtype=torch.int32, device=dev))

    def all_done(t: int) -> bool:
        full = torch.isfinite(hyp[0]).all(dim=1)
        if not gc.early_stopping:
            # BeamHypotheses.is_done: generated length in the denominator
            full = full & (hyp[0].min(dim=1).values
                           >= best_cum / norm(t))
        return bool(full.all())

    t = 1
    while t < max_new and not all_done(t):
        flat_parent = (rowi[:, None] * K + parent).reshape(-1)
        cache = dataclasses.replace(cache, k=cache.k[:, flat_parent],
                                    v=cache.v[:, flat_parent])
        emb = llm.tok_embeddings(tok.reshape(-1))[:, None, :]
        # the token fed here was generated at step t - 1: position
        # pos + (t - 1), shared by the row's beams
        pos_bk = pos.repeat_interleave(K)[:, None] + float(t - 1)
        logits, cache = internlm2.llm_forward(
            llm, cfg.llm, inputs_embeds=emb, rope_pos_ids=pos_bk,
            kv_cache=cache, kv_valid=kv_valid_at(t))
        logp = torch.log_softmax(logits[:, -1], dim=-1).reshape(B, K, V)
        scores, tok, parent, out, best_cum = process(t, logp, scores, hyp,
                                                     out)
        t += 1

    # ---- finalize: open beams join the pool (generated length t), best wins
    open_score = scores / norm(t)
    for i in range(K):
        offer(hyp, open_score[:, i], out[:, i], t)
    best = torch.argmax(hyp[0], dim=1)
    return hyp[1][rowi, best], hyp[2][rowi, best]
