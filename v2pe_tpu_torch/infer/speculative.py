"""Prompt-lookup speculative decoding over the paged KV cache (port of
``v2pe_tpu/infer/speculative.py``).

Greedy decode that verifies K drafted tokens per forward and keeps only the
tokens the plain greedy loop would have produced (token-exact in fp32).
Drafts come from prompt lookup: the most recent earlier occurrence of the
last ``g`` tokens proposes its continuation. Each iteration

1. drafts K tokens by n-gram matching over the token buffer;
2. runs ONE (K+1)-token forward through the paged multi-token path
   (``llm_forward`` with S <= 16: the paged decode kernel over the pages
   plus the causal fold of the fresh tokens), which also writes all K+1
   fresh k/v into the pages;
3. accepts the longest prefix where draft == greedy argmax and advances
   ``lengths`` by the accepted count only: rejected slots are overwritten by
   the next iteration's writes.

The JAX ``lax.while_loop`` is a Python loop here; everything else stays on
the device, and the loop's test ``all(done)`` is the one value it reads
back per iteration.
"""

from __future__ import annotations

import torch

from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.parallel.mesh import serving_mode


def prompt_lookup_draft(ctx_ids: torch.Tensor, n_ctx: torch.Tensor, k: int,
                        g: int) -> torch.Tensor:
    """Draft ``k`` continuation tokens per row by matching the row's last
    ``g`` tokens against its earlier context.

    ctx_ids (B, Lbuf) int32 (prompt + generated so far, anything beyond
    ``n_ctx``); n_ctx (B,) int32. Returns (B, k) int32. Without a match the
    draft is whatever follows position 0 or the buffer's tail: harmless,
    verification rejects what the greedy loop would not emit."""
    B, Lbuf = ctx_ids.shape
    dev = ctx_ids.device
    npos = Lbuf - g + 1                      # candidate match starts
    n = n_ctx.long()
    # a negative index wraps from the end, as in jnp.take_along_axis
    gram_idx = (n[:, None] - g + torch.arange(g, device=dev)[None]) % Lbuf
    gram = torch.gather(ctx_ids, 1, gram_idx)
    match = torch.ones((B, npos), dtype=torch.bool, device=dev)
    for j in range(g):
        match &= ctx_ids[:, j:j + npos] == gram[:, j:j + 1]
    # exclude the suffix itself (i == n_ctx - g) and anything past it
    match &= torch.arange(npos, device=dev)[None] <= (n - g - 1)[:, None]
    # the most recent match; start npos - 1 - 0 when there is none (argmax
    # of an all-false row is 0)
    idx = (npos - 1) - torch.argmax(match.flip(1).to(torch.int8), dim=1)
    take = torch.clamp(idx[:, None] + g + torch.arange(k, device=dev)[None],
                       0, Lbuf - 1)
    return torch.gather(ctx_ids, 1, take)


def _prefix(ok: torch.Tensor) -> torch.Tensor:
    """(B, K) bool -> (B, K+1) int: column 0 is 1, column i the running
    product of ok[:, :i]."""
    one = torch.ones((ok.shape[0], 1), dtype=torch.int32, device=ok.device)
    return torch.cumprod(torch.cat([one, ok.to(torch.int32)], dim=1), dim=1)


def verify_step(llm, lcfg, cache: pk.PagedKVCache, ctx, n_ctx, tok, pos,
                alive, budget, eos, K: int, g: int):
    """One draft-and-verify iteration over every row, shared by
    :func:`speculative_decode_from_logits` and the serving engine's
    speculative block. ``alive`` (B,) bool rows take part; ``budget`` (B,)
    int32 is how many more tokens a row may emit. Writes the K+1 fresh k/v
    of the alive rows into the pool. Returns (y (B, K+1) greedy tokens, keep
    (B, K+1) bool prefix mask of the emitted ones, m (B,) their count,
    emitted_eos (B,) bool)."""
    B = tok.shape[0]
    dev = tok.device
    draft = prompt_lookup_draft(ctx, n_ctx, K, g)
    x = torch.cat([tok[:, None], draft], dim=1)                # (B, K+1)
    off = torch.arange(K + 1, device=dev)
    seg = alive.to(torch.int32)[:, None].expand(B, K + 1)
    logits, _ = internlm2.llm_forward(
        llm, lcfg, inputs_embeds=llm.tok_embeddings(x),
        rope_pos_ids=pos[:, None] + off[None].float(), segment_ids=seg,
        paged_cache=cache)
    y = torch.argmax(logits, dim=-1).to(torch.int32)
    y_eos = torch.isin(y, eos)
    # keep[i]: y_i is a real output: all drafts before it verified, no eos
    # emitted earlier in this forward, the row alive and under its budget.
    # Every factor is prefix-monotone, so keep is a prefix mask.
    keep = (_prefix(x[:, 1:] == y[:, :-1]) * _prefix(~y_eos[:, :-1])
            ).bool() & (off[None] < budget[:, None]) & alive[:, None]
    m = keep.sum(dim=1, dtype=torch.int32)
    return y, keep, m, (keep & y_eos).any(dim=1)


def scatter_kept(buf: torch.Tensor, start: torch.Tensor, y: torch.Tensor,
                 keep: torch.Tensor) -> None:
    """buf[b, start[b] + i] = y[b, i] where keep[b, i], in place. Entries
    that are not kept rewrite what their slot holds, so no two writes of a
    row meet; ``buf`` must be wider than any ``start + i`` (the callers'
    buffers leave K+1 slots of slack)."""
    W = buf.shape[1]
    idx = start.long()[:, None] + torch.arange(y.shape[1],
                                               device=buf.device)[None]
    keep = keep & (idx < W)
    idx = idx.clamp_max(W - 1)
    buf.scatter_(1, idx, torch.where(keep, y, torch.gather(buf, 1, idx)))


@serving_mode
def speculative_decode_from_logits(llm, lcfg, gc, cache: pk.PagedKVCache,
                                   last_logits, last_pos, ctx_ids, n_ctx):
    """Greedy decode with prompt-lookup speculation: the speculative
    counterpart of :func:`v2pe_tpu_torch.infer.generate.decode_from_logits`
    (token-exact against it in fp32).

    ``ctx_ids`` (B, Lbuf) int32 holds the prompt tokens (right-padded rows
    are fine: matching is bounded by ``n_ctx``) with room for max_new_tokens
    more; it is written in place. ``cache`` is a PagedKVCache whose rows'
    page tables leave room for ``lengths + max_new + K + 1`` tokens. Returns
    (out (B, max_new) int32, steps taken, lens (B,), cache)."""
    if gc.do_sample:
        raise ValueError("speculative decoding is greedy-only")
    K, g = int(gc.speculative_k), int(gc.speculative_ngram)
    if not 1 <= K <= 15:
        raise ValueError("K+1 must ride the <=16-token paged path")
    B = last_logits.shape[0]
    dev = last_logits.device
    max_new = gc.max_new_tokens
    eos = torch.tensor(gc.eos_token_ids, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)

    # the first output token from the prefill logits, as decode_from_logits
    tok = torch.argmax(last_logits, dim=-1).to(torch.int32)
    out = torch.zeros((B, max_new + K + 1), dtype=torch.int32, device=dev)
    out[:, 0] = tok
    n_ctx = n_ctx.to(device=dev, dtype=torch.int32)
    ctx_ids[rows, n_ctx.long()] = tok
    n_ctx = n_ctx + 1
    n_out = torch.ones((B,), dtype=torch.int32, device=dev)
    done = torch.isin(tok, eos) | (n_out >= max_new)
    pos = last_pos + 1.0
    steps = 0
    while not bool(done.all()):
        cache = pk.allocate_rows(
            cache, torch.where(done, 0, K + 1).to(torch.int32))
        y, keep, m, emitted_eos = verify_step(
            llm, lcfg, cache, ctx_ids, n_ctx, tok, pos, ~done,
            max_new - n_out, eos, K, g)
        scatter_kept(out, n_out, y, keep)
        scatter_kept(ctx_ids, n_ctx, y, keep)
        # lengths advance by the accepted INPUT count (x_0..x_{m-1})
        cache = pk.advance_lengths(cache, m)
        last_kept = torch.gather(y, 1, (m - 1).clamp_min(0).long()[:, None]
                                 )[:, 0]
        tok = torch.where(done, tok, last_kept)
        n_out, n_ctx, pos = n_out + m, n_ctx + m, pos + m.float()
        done = done | emitted_eos | (n_out >= max_new)
        steps += 1
    return out[:, :max_new], steps, torch.clamp(n_out, max=max_new), cache
