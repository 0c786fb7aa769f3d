"""Continuous-batching inference engine over the shared paged KV pool (port
of ``v2pe_tpu/serve/engine.py``).

Requests run through ONE batched decode continuously:

* one physical page pool (``infer/paged_kv.PagedKVCache``) shared by up to
  ``max_rows`` in-flight requests; a host-side free-list
  :class:`PageAllocator` reserves each request's worst case (prompt +
  max_new_tokens) at admission and reclaims it at completion, so pages
  cycle for ever;
* admission runs the new prompt through fixed-size chunked prefill onto its
  row (the paged prefill kernel over the row's cached pages, merged with the
  chunk's causal self-attention) while the other rows' state sits in the
  pool; with the prefix cache, full prompt pages are shared between
  requests and a repeated prefix skips its prefill;
* decode runs in blocks of K steps over ALL rows at once, with per-row
  active masks and token budgets kept on the device inside the block: a row
  that samples its stop token or exhausts ``max_new_tokens`` stops
  advancing; between blocks the host harvests the (B, K) emitted tokens in
  one read, streams them to each request, retires finished rows (page-table
  row -> -1: the kernels treat -1 entries as dead and the store leaves them
  alone, so a retired row can never touch reused pages), and admits queued
  requests into the freed rows;
* with ``speculative_k > 0`` a block is ``decode_block`` prompt-lookup
  verify iterations (``infer/speculative.py``), suspended adaptively when
  drafts do not hit.

Differences from the JAX engine, by design: the pool, the page table and
the lengths are written in place (JAX donates them to each jitted block);
the decode state (token, position, active, budget per row) lives on the
device between blocks and the host keeps mirrors from each harvest;
sampling draws from a ``torch.Generator`` on the engine's device; a request
keeps the logits its first token was sampled from.

Under a ``ShardingContext`` the pool is split as JAX's mesh splits it: its
page axis over ``paged_kv.pool_shards()`` shards (``seq_shards`` on one
card, which holds them all; the ``seq`` axis across processes, each rank
holding NP/n pages) and, across processes, its kv heads over ``tensor``
where the model's attention is split. The allocator places a row's page at
table slot s on shard s % n. Across processes every rank runs this same
scheduler on the same requests: its decisions depend only on the requests
and on the tokens, which every rank samples alike (greedy, or a generator
seeded alike), so the ranks agree without exchanging them.

The decoder is the one the config names (``models/decoder.py``). A
DeepSeek-V3 decoder (latent attention, ``decoder.is_mla``) serves from a
latent pool (``PagedKVCache.latents``: one bf16 tensor of latents, the
same page tables, allocator and prefix cache) through kernel #12; a
quantized pool, speculation and a ``ShardingContext`` are refused for it.
Its MoE layers add the span ``moe`` (in ``prefill`` and
``decode_launch``) and the counters of :data:`MOE_STATS`, which accumulate
on the device and come back in each harvest's one read. With
``record_routes`` a request keeps, for each token it was served, the
experts each MoE layer chose at the position that produced it
(``EngineRequest.routes``): the admission reads the first token's with the
first token, and a decode block's ride in its harvest.

Spans and counters: the scheduler times itself through ``spans``
(``utils/profiling.SpanRecorder``), each span adding its nanoseconds to the
counter ``<name>_ns`` in ``stats`` (:data:`SPANS`). ``step`` is all of a
scheduler step; in it ``plan`` (every admission plan, failed ones too;
within it ``digest``: keying a request that came without keys, the pixel
blake2b and the page-key chain), ``admit`` (within it ``pixel_upload``,
``vit``: the ViT and the scatter, host time, ``prefill``: the chunks,
``first_token``: its read, which waits for the prefill) and
``decode_block`` (within it ``decode_launch``: issuing the block,
``harvest``: its one read, which waits for it, ``drain``: handing out
tokens and retiring rows, the tokenizer's decode included). Counters beside
them: ``admissions``, ``queue_wait_ns`` (submit to the start of the plan
that admitted the request, the keying at submit included),
``keyed_at_submit`` (admissions whose keys ``submit`` made) and
``submit_digest_ns`` (those requests' ``key_ns``), ``prefill_chunks``,
``prefill_tokens`` (valid) and ``prefill_pad_tokens``,
``prefix_hit_pages`` and ``prefix_hit_tokens``, ``decode_blocks``,
``decode_steps`` (forwards) and ``retired``. A request keeps
``submit_ns``, ``admit_ns``, ``first_token_ns``, ``cached_tokens`` (its
prompt tokens the prefix cache served) and ``key_ns``. With the prefix
cache on, ``submit`` keys the prompt's pages on the caller's thread,
outside the scheduler's lock, so ``digest`` stays 0 on that path; the
caller times its own keying (``key_ns``) and the scheduler adds it up at
admission, ``stats`` keeping the scheduler as its one writer. Every time
is ``time.time_ns()``, the clock of a ``torch.profiler`` trace.
``spans.record()`` attaches a bounded log of the spans, each ``(name,
start_ns, end_ns, parent, request_id)`` (an admission's and a plan's carry
the request's id), and ``spans.drain()`` takes what it holds; the log is
off by default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.infer.generate import GenerationConfig, _sample
from v2pe_tpu_torch.infer.speculative import scatter_kept, verify_step
from v2pe_tpu_torch.models import decoder, internlm2, internvl_chat
from v2pe_tpu_torch.parallel import context as pctx
from v2pe_tpu_torch.parallel.mesh import serving_mode
from v2pe_tpu_torch.utils.profiling import SpanRecorder

logger = logging.getLogger(__name__)

# the scheduler's spans, each also a ``<name>_ns`` counter in ``stats``
SPANS = ("step", "plan", "digest", "admit", "pixel_upload", "vit", "prefill",
         "first_token", "decode_block", "decode_launch", "harvest", "drain")
# an MLA decoder's expert counters in ``stats`` (with its span ``moe``):
# (token, expert) pairs, experts with a token, the busiest expert's tokens,
# each summed over MoE layers and forwards
MOE_STATS = ("moe_assignments", "moe_experts_hit", "moe_max_load")


# ---------------------------------------------------------------------------
# host-side page accounting
# ---------------------------------------------------------------------------


class PageAllocator:
    """Free-list over the pool's physical page ids.

    With ``n_shards > 1`` (sequence-sharded pool) the physical range is
    split per shard and a row's page at table slot s must live on shard
    s % n_shards - the placement invariant that a multi-card pool's
    compacted local page view relies on. Each shard's local page 0 (global
    d*NP/n) is its reserved null page and is never handed out."""

    def __init__(self, n_pages: int, n_shards: int = 1):
        if n_pages % n_shards:
            raise ValueError(f"{n_pages} pages do not split over {n_shards} "
                             f"shards")
        self.n_pages = n_pages
        self.n_shards = n_shards
        self.pages_per_shard = n_pages // n_shards
        self._free: List[List[int]] = [
            list(range(d * self.pages_per_shard + 1,
                       (d + 1) * self.pages_per_shard))
            for d in range(n_shards)]

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    @property
    def available(self) -> int:
        return sum(len(f) for f in self._free)

    def _demand(self, n: int, first_slot: int) -> List[int]:
        d = [0] * self.n_shards
        for s in range(first_slot, first_slot + n):
            d[s % self.n_shards] += 1
        return d

    def shortage(self, n: int, first_slot: int = 0) -> dict:
        """Per-shard page deficit for an ``alloc(n, first_slot)``."""
        return {d: need - len(self._free[d])
                for d, need in enumerate(self._demand(n, first_slot))
                if need > len(self._free[d])}

    def alloc(self, n: int, first_slot: int = 0) -> Optional[List[int]]:
        """Pages for table slots first_slot..first_slot+n-1, in slot
        order, respecting the slot->shard placement invariant."""
        if self.shortage(n, first_slot):
            return None
        return [self._free[(first_slot + i) % self.n_shards].pop()
                for i in range(n)]

    def release(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._free[self.shard_of(int(p))].append(int(p))


class PrefixCache:
    """Automatic prefix caching: hash-chained FULL prompt pages shared
    across requests (the vLLM block-hash model). Page i of a prompt is
    keyed by ``H(key_{i-1}, ids[i*ps:(i+1)*ps], pos[i*ps:(i+1)*ps])``
    seeded with a digest of the request's pixel data - V2PE's fractional
    positions and the image content both shape the stored kv, so both are
    part of the identity; two prompts share a page only when every token,
    every rotary position, and the media bytes before it match.

    Pages carry a refcount; at refcount 0 they are NOT freed but parked
    in an LRU - a later identical prefix re-acquires them and skips its
    prefill entirely. The engine evicts parked pages (oldest first,
    de-registering their keys) only when the free list runs dry. KV pages
    are append-only (prefill/decode write strictly past ``lengths``), so
    a shared page is immutable by construction - no copy-on-write needed.

    The engine keys a request once, in ``InferenceEngine.submit`` on the
    caller's thread (:meth:`request_keys`), and keeps the chain on
    ``EngineRequest.keys`` and the time it took on ``EngineRequest.key_ns``;
    the scheduler only matches and reserves, and counts such admissions in
    ``stats["keyed_at_submit"]`` and their keying time in
    ``stats["submit_digest_ns"]``. A request that reaches the plan without
    keys is keyed there, in the ``digest`` span. So the pixels are keyed as
    they are at submit: a caller must not change the array after submitting
    it (the upload at admission reads it later still).
    """

    def __init__(self):
        self._page_of: dict = {}          # key -> page id
        self._key_of: dict = {}           # page id -> key
        self._ref: dict = {}              # page id -> refcount
        self._lru: "dict[int, None]" = {}  # parked refcount-0 pages, FIFO
        self.hits = 0

    @property
    def evictable(self) -> int:
        return len(self._lru)

    @staticmethod
    def request_keys(ids: np.ndarray, pos: np.ndarray,
                     pixel_values: Optional[np.ndarray],
                     page_size: int) -> List[bytes]:
        """A prompt's key chain, seeded with the blake2b of its pixels'
        bytes in C order (``b""`` without pixels). hashlib reads a
        C-contiguous array's buffer in place (no copy) and releases the
        GIL while it hashes."""
        seed = b"" if pixel_values is None else hashlib.blake2b(
            np.ascontiguousarray(pixel_values), digest_size=16).digest()
        return PrefixCache.chain_keys(ids, pos, page_size, seed)

    @staticmethod
    def chain_keys(ids: np.ndarray, pos: np.ndarray, page_size: int,
                   seed: bytes = b"") -> List[bytes]:
        keys, h = [], seed
        for i in range(len(ids) // page_size):
            sl = slice(i * page_size, (i + 1) * page_size)
            h = hashlib.blake2b(
                h + np.asarray(ids[sl], np.int64).tobytes()
                + np.asarray(pos[sl], np.float32).tobytes(),
                digest_size=16).digest()
            keys.append(h)
        return keys

    def match(self, keys: Sequence[bytes]) -> int:
        """Longest cached prefix (in pages) of the key chain."""
        n = 0
        for k in keys:
            if k not in self._page_of:
                break
            n += 1
        return n

    def acquire(self, key: bytes) -> int:
        """Take a reference on the cached page for ``key``."""
        page = self._page_of[key]
        self._ref[page] += 1
        self._lru.pop(page, None)
        self.hits += 1
        return page

    def register(self, key: bytes, page: int) -> bool:
        """Publish a freshly written page under ``key`` (ref already 1 -
        the registering row). No-op if the key is already cached (the
        duplicate page stays private to its row)."""
        if key in self._page_of:
            return False
        self._page_of[key] = page
        self._key_of[page] = key
        self._ref[page] = 1
        return True

    def release(self, page: int) -> None:
        """Drop a reference; at zero the page parks in the LRU."""
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._lru[page] = None

    def evict(self, n: int, pred=None) -> List[int]:
        """De-register up to ``n`` parked pages (oldest first), optionally
        only those matching ``pred(page)`` (per-shard eviction under a
        sequence-sharded pool)."""
        out = []
        for page in list(self._lru):
            if len(out) == n:
                break
            if pred is not None and not pred(page):
                continue
            del self._lru[page]
            del self._ref[page]
            del self._page_of[self._key_of.pop(page)]
            out.append(page)
        return out


@dataclasses.dataclass
class EngineRequest:
    """One in-flight generation. ``token_queue`` receives generated token
    ids as they are harvested (``None`` sentinel on completion)."""

    ids: np.ndarray                  # (S,) prompt token ids
    pos: np.ndarray                  # (S,) float32 V2PE positions
    max_new_tokens: int
    pixel_values: Optional[np.ndarray] = None   # (T, 3, sz, sz)
    request_id: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_queue: "queue.Queue" = dataclasses.field(
        default_factory=queue.Queue)
    finished: "threading.Event" = dataclasses.field(
        default_factory=threading.Event)
    _text: Optional[str] = None
    error: Optional[BaseException] = None  # scheduler failure (fail_all)
    # (V,) fp32 logits the first token was sampled from, on the engine's
    # device (the port keeps them, as ChatSession keeps last_logits)
    first_logits: Optional["torch.Tensor"] = None
    # time.time_ns() at the submit, at the start of the plan that admitted
    # the request and once its first token was read
    submit_ns: int = 0
    admit_ns: int = 0
    first_token_ns: int = 0
    cached_tokens: int = 0           # prompt tokens the prefix cache served
    # the prompt's page-key chain, made at submit when the engine caches
    # prefixes (None: keyed by the plan instead), and the ns it took
    keys: Optional[List[bytes]] = None
    key_ns: int = 0
    # with the engine's record_routes (latent-attention decoder): for each
    # served token, the (MoE layers, k) experts chosen where it was sampled
    routes: List[np.ndarray] = dataclasses.field(default_factory=list)

    def result(self, timeout: Optional[float] = None) -> str:
        self.finished.wait(timeout)
        if self.error is not None:
            raise RuntimeError(
                f"engine request {self.request_id} failed") from self.error
        return self._text


# ---------------------------------------------------------------------------
# device steps: plain functions on tensors that write the pool, the page
# table, the lengths and the rows' decode state in place
# ---------------------------------------------------------------------------


def _prefill_row_chunk(llm, lcfg, cache: pk.PagedKVCache, row: int, embeds,
                       pos, seg, n_valid: int, want_logits: bool):
    """One fixed-size prompt chunk into row ``row`` of the shared cache: the
    chunked-prefill arm of ``llm_forward`` (the row's cached pages plus the
    chunk's causal self-attention) on a batch-1 view, the row's length
    advanced by the chunk's ``n_valid`` tokens. The view's page table and
    lengths are slices of the cache's own tensors, so the advance reaches the
    engine's lengths, once. Returns the fp32 logits (V,) at the chunk's last
    valid position when asked for them."""
    view = dataclasses.replace(cache,
                               page_table=cache.page_table[row:row + 1],
                               lengths=cache.lengths[row:row + 1])
    hidden, _ = decoder.llm_forward(
        llm, lcfg, inputs_embeds=embeds, rope_pos_ids=pos, segment_ids=seg,
        paged_cache=view, paged_attend_cache=True, return_hidden=True)
    view.lengths.add_(n_valid)
    if not want_logits:
        return None
    return internlm2.head_logits(hidden[:, max(n_valid - 1, 0)],
                                 llm.output)[0]


def _first_token(logits, gc, generator) -> int:
    return int(_sample(logits[None], gc, generator)[0])


def _decode_block(llm, lcfg, gc, cache: pk.PagedKVCache, tok, pos, active,
                  rem, eos, generator, k: int):
    """K decode steps over every row at once. ``active`` rows write their
    fed token's k/v at slot ``lengths`` (store, then attend) and advance;
    inactive rows ride along: a retired row's store finds a dead (-1) table
    entry and does nothing, a row that stopped inside the block is stored
    to at its unadvanced length, and both rows' samples are discarded. A row
    deactivates inside the block when it samples a stop token or its ``rem``
    budget reaches zero. ``tok``, ``pos``, ``active``, ``rem`` and the
    cache's lengths are updated in place and nothing is read back. Returns
    emitted (B, k) int32, -1 where nothing was emitted."""
    B = tok.shape[0]
    emitted = torch.full((B, k), -1, dtype=torch.int32, device=tok.device)
    for i in range(k):
        emb = llm.tok_embeddings(tok)[:, None, :]
        logits, _ = decoder.llm_forward(
            llm, lcfg, inputs_embeds=emb, rope_pos_ids=pos[:, None],
            paged_cache=cache)
        step = active.to(torch.int32)
        cache.lengths.add_(step)
        nxt = _sample(logits[:, -1], gc, generator).to(torch.int32)
        emitted[:, i] = torch.where(active, nxt, -1)
        rem.sub_(step)
        pos.add_(step.to(pos.dtype))
        still = active & ~torch.isin(nxt, eos) & (rem > 0)
        tok.copy_(torch.where(still, nxt, tok))
        active.copy_(still)
    return emitted


def _spec_block(llm, lcfg, gc, cache: pk.PagedKVCache, ctx_buf, n_ctx, tok,
                pos, active, rem, eos, n_iters: int):
    """``n_iters`` prompt-lookup verify iterations over every row at once,
    the speculative counterpart of :func:`_decode_block`: each drafts K
    tokens per row from the row's ``ctx_buf`` history, verifies K+1 in one
    forward and emits the accepted prefix. State is updated in place.
    Returns emitted (B, n_iters * (K+1)) int32, -1 where nothing was
    emitted."""
    K, g = int(gc.speculative_k), int(gc.speculative_ngram)
    B = tok.shape[0]
    emitted = torch.full((B, n_iters * (K + 1)), -1, dtype=torch.int32,
                         device=tok.device)
    for it in range(n_iters):
        y, keep, m, emitted_eos = verify_step(
            llm, lcfg, cache, ctx_buf, n_ctx, tok, pos, active, rem, eos, K,
            g)
        emitted[:, it * (K + 1):(it + 1) * (K + 1)] = torch.where(keep, y,
                                                                  -1)
        scatter_kept(ctx_buf, n_ctx, y, keep)
        cache.lengths.add_(m)    # 0 for a row that is not active
        last_kept = torch.gather(y, 1, (m - 1).clamp_min(0).long()[:, None]
                                 )[:, 0]
        tok.copy_(torch.where(active & (m > 0), last_kept, tok))
        n_ctx.add_(m)
        pos.add_(m.to(pos.dtype))
        rem.sub_(m)
        active.copy_(active & ~emitted_eos & (rem > 0))
    return emitted


def _append_ctx(ctx_buf, n_ctx, emitted) -> None:
    """Append a plain decode block's emitted tokens (-1 = none; a row's
    tokens are a prefix of its columns) to the draft context buffer, in
    place: the history stays current while speculation is suspended, so the
    re-probe block drafts from the real tail of each stream."""
    valid = emitted >= 0
    scatter_kept(ctx_buf, n_ctx, emitted.clamp_min(0), valid)
    n_ctx.add_(valid.sum(dim=1, dtype=torch.int32))


def _set_ctx_row(ctx_buf, row: int, vals: np.ndarray) -> None:
    """Install an admitted row's prompt (+ first token) into the draft
    context buffer; ``vals`` is zero past them."""
    ctx_buf[row] = torch.as_tensor(vals, device=ctx_buf.device)


def _set_row(cache: pk.PagedKVCache, row: int, table_row: np.ndarray,
             length0: int) -> None:
    """Install a freshly admitted row's page table. ``length0`` > 0 when a
    cached prefix already fills the row's leading pages (prefix cache)."""
    cache.page_table[row] = torch.as_tensor(table_row,
                                            device=cache.page_table.device)
    cache.lengths[row].fill_(length0)


def _clear_rows(cache: pk.PagedKVCache, rows: Sequence[int]) -> None:
    """Retire finished rows: dead (-1) table entries and zero lengths, so
    the decode kernels skip them and the store leaves them alone: the freed
    physical pages can be handed to other rows at once. (``fill_`` on a
    view: assigning a Python number to an index copies it from the host,
    which waits for the card.)"""
    for row in rows:
        cache.page_table[row].fill_(-1)
        cache.lengths[row].fill_(0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class InferenceEngine:
    """Continuous batching over one shared paged pool.

    Args:
      chat_model: a :class:`~v2pe_tpu_torch.infer.chat.ChatModel` (weights,
        tokenizer, template). The engine runs on the device of its weights.
      max_rows: maximum concurrently decoding requests (the batch size of
        the decode block).
      max_len: maximum prompt+generation length of a single request (sets
        the page-table width, i.e. the decode kernel's page sweep bound).
      pool_tokens: total KV capacity in tokens across all rows (defaults
        to ``max_rows * max_len``: no oversubscription; smaller values
        oversubscribe and rely on admission control).
      chunk_size: prefill chunk length (prompts are padded up to a
        multiple).
      decode_block: decode steps per block (the host harvests and admits
        between blocks, so this bounds the TTFT added while a block is in
        flight).
      generation_config: engine-wide sampling settings; per-request
        ``max_new_tokens`` is honored via the in-block budget. Stop ids
        default to the model's template stop tokens.
      kv_dtype: None (model dtype), 'int8' (quantized pool: twice the
        tokens per byte) or 'int4' (twice again; packed bytes).
      generator: the ``torch.Generator`` sampling draws from (on the
        engine's device; seeded with 0 by default).
      record_routes: with a DeepSeek-V3 decoder, keep each served token's
        expert choices on its request (``EngineRequest.routes``), for an
        output check; an attribute, read at each admission and block.
    """

    def __init__(self, chat_model, *, max_rows: int = 8,
                 max_len: int = 8192, pool_tokens: Optional[int] = None,
                 page_size: int = 512, chunk_size: int = 512,
                 decode_block: int = 16,
                 generation_config: Optional[GenerationConfig] = None,
                 kv_dtype=None, prefix_caching: bool = True,
                 spec_min_accept: float = 1.5,
                 spec_reprobe_blocks: int = 16,
                 generator: Optional[torch.Generator] = None,
                 record_routes: bool = False):
        self.m = chat_model
        self.record_routes = record_routes
        self.cfg = chat_model.cfg
        self.max_rows = max_rows
        self.max_len = max_len
        self.page_size = page_size
        self.chunk_size = chunk_size
        self.decode_block = decode_block
        MP = -(-max_len // page_size)
        self.max_pages_per_row = MP
        pool_tokens = pool_tokens or max_rows * max_len
        # captured once: the pool is laid out for this context, and every
        # step runs under it (parallel/context.py)
        self.ctx = pctx.current()
        # per shard: its pages and its reserved local null page 0
        n_shards, shard = pk.pool_shards()
        NP = n_shards * (-(-pool_tokens // (page_size * n_shards)) + 1)
        emb = chat_model.model.llm.tok_embeddings.weight
        self.device = dev = emb.device
        gc = generation_config or GenerationConfig()
        if not gc.eos_token_ids:
            stop = tuple(chat_model.conv_template.stop_token_ids) or \
                (self.cfg.llm.eos_token_id,)
            gc = dataclasses.replace(gc, eos_token_ids=stop)
        self.gc = gc
        self._eos = torch.tensor(gc.eos_token_ids, dtype=torch.int32,
                                 device=dev)
        # speculative continuous batching (_spec_block): drafts ride a
        # per-row device-side token-history buffer; verify writes need
        # K+1 slots of slack past prompt+max_new
        self._spec = gc.speculative_k > 0
        if self._spec and gc.do_sample:
            raise ValueError("speculative engine decode is greedy-only")
        if self._spec and not 1 <= gc.speculative_k <= 15:
            raise ValueError("speculative_k must be 1..15")
        self._spec_slack = gc.speculative_k + 1 if self._spec else 0
        # adaptive off-switch: a workload whose drafts do not hit pays the
        # (K+1)-token verify forward for about one token, for ever. Track
        # acceptance per verify forward per active row (EMA over blocks);
        # below ``spec_min_accept`` drafting SUSPENDS for
        # ``spec_reprobe_blocks`` plain decode blocks, then one speculative
        # block probes again (a copy-heavy span can appear mid-stream).
        self.spec_min_accept = float(spec_min_accept)
        self.spec_reprobe_blocks = int(spec_reprobe_blocks)
        self._spec_accept_ema: Optional[float] = None
        self._spec_suspended_for = 0
        self._ctx_dev = torch.zeros(
            (max_rows, max_len + self._spec_slack + 8), dtype=torch.int32,
            device=dev) if self._spec else None
        llm = chat_model.model.llm
        self._mla = decoder.is_mla(self.cfg.llm)
        if self._mla:
            refused = [why for why, on in (
                (f"kv_dtype={kv_dtype!r} (a quantized pool)",
                 kv_dtype is not None),
                ("speculative_k > 0", self._spec),
                ("a sharded pool or model (ShardingContext)",
                 self.ctx is not None or n_shards > 1)) if on]
            if refused:
                raise ValueError(
                    f"the latent-attention (MLA) decoder serves from a bf16 "
                    f"latent pool on one card; refused: {'; '.join(refused)}")
            self.cache = pk.PagedKVCache.latents(
                self.cfg.llm, max_rows, NP, page_size, MP, dtype=emb.dtype,
                device=dev)
        else:
            self.cache = pk.PagedKVCache.zeros(
                self.cfg.llm, max_rows, NP, page_size, MP, dtype=emb.dtype,
                kv_dtype=kv_dtype, device=dev, n_shards=n_shards, shard=shard,
                kv_heads=internlm2.local_kv_heads(llm, self.cfg.llm))
        self.allocator = PageAllocator(NP, n_shards=n_shards)
        self.prefix_cache = PrefixCache() if prefix_caching else None
        # every key there from the start: a reader copying the dict from
        # another thread never sees it grow
        self.stats = dict.fromkeys(
            ("prefill_chunks", "prefix_hit_pages", "admissions",
             "queue_wait_ns", "keyed_at_submit", "submit_digest_ns",
             "prefill_tokens", "prefill_pad_tokens", "prefix_hit_tokens",
             "decode_blocks", "decode_steps", "retired")
            + tuple(f"{name}_ns" for name in SPANS), 0)
        self.spans = SpanRecorder(self.stats)
        if self._mla:
            # the MoE layers' span and counters (models/deepseek_v3.py): the
            # counters accumulate on the device and come back with each
            # harvest
            self.stats.update(dict.fromkeys(MOE_STATS + ("moe_ns",), 0))
            llm.spans = self.spans
            llm.moe_counts = torch.zeros(len(MOE_STATS), dtype=torch.int64,
                                         device=dev)
        # per-row state: on the device (what the blocks run on, updated in
        # place) and its host mirrors (what the scheduler reads, refreshed
        # by each block's one harvest)
        self._row_req: List[Optional[EngineRequest]] = [None] * max_rows
        self._row_pages: List[List[int]] = [[] for _ in range(max_rows)]
        # pages participating in the prefix cache, per row: [(page, key)]
        self._row_cached: List[List] = [[] for _ in range(max_rows)]
        self._tok = np.zeros(max_rows, np.int32)
        self._pos = np.zeros(max_rows, np.float32)
        self._active = np.zeros(max_rows, bool)
        self._rem = np.zeros(max_rows, np.int32)
        self._nctx = np.zeros(max_rows, np.int32)
        self._dev = {
            "tok": torch.zeros(max_rows, dtype=torch.int32, device=dev),
            "pos": torch.zeros(max_rows, dtype=torch.float32, device=dev),
            "active": torch.zeros(max_rows, dtype=torch.bool, device=dev),
            "rem": torch.zeros(max_rows, dtype=torch.int32, device=dev),
            "nctx": torch.zeros(max_rows, dtype=torch.int32, device=dev),
        }
        self._queue: "deque[EngineRequest]" = deque()
        self._ids = itertools.count()
        self._generator = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._failed: Optional[BaseException] = None

    # ------------------------------------------------------------ submission
    def submit(self, ids: np.ndarray, pos: np.ndarray,
               pixel_values: Optional[np.ndarray] = None,
               max_new_tokens: int = 256) -> EngineRequest:
        """Queue raw (ids, positions) for generation. With the prefix cache
        on, the prompt's page keys are made here, on the calling thread and
        outside the scheduler's lock (``PrefixCache``)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        need = -(-(len(ids) + max_new_tokens + self._spec_slack)
                 // self.page_size)
        if len(ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+max_new {len(ids) + max_new_tokens} exceeds the "
                f"engine max_len {self.max_len}")
        if -(-need // self.allocator.n_shards) > \
                self.allocator.pages_per_shard - 1:
            raise ValueError("request can never fit the page pool")
        req = EngineRequest(ids=ids, pos=np.asarray(pos, np.float32),
                            max_new_tokens=max_new_tokens,
                            pixel_values=pixel_values,
                            request_id=next(self._ids),
                            submit_ns=time.time_ns())
        if self.prefix_cache is not None:
            t0 = time.time_ns()
            req.keys = PrefixCache.request_keys(req.ids, req.pos,
                                                pixel_values, self.page_size)
            req.key_ns = time.time_ns() - t0
        with self._wake:
            if self._failed is not None:
                raise RuntimeError("engine scheduler has failed") \
                    from self._failed
            self._queue.append(req)
            self._wake.notify()
        return req

    def submit_chat(self, pixel_values: Optional[np.ndarray], question: str,
                    max_new_tokens: int = 256, history=None,
                    num_patches_list=None,
                    rope_pos_id_version: Optional[str] = None,
                    rope_pos_id_stride: Optional[int] = None
                    ) -> EngineRequest:
        """Prompt-building convenience mirroring ``ChatModel.chat``."""
        if num_patches_list is None:
            num_patches_list = [pixel_values.shape[0]] \
                if pixel_values is not None else []
        if history is None and pixel_values is not None \
                and "<image>" not in question:
            question = "<image>\n" + question
        ids, pos, _ = self.m.encode_chat(
            question, num_patches_list, history,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)
        return self.submit(ids, pos, pixel_values=pixel_values,
                           max_new_tokens=max_new_tokens)

    # ------------------------------------------------------------- scheduler
    def _free_row(self) -> Optional[int]:
        for r in range(self.max_rows):
            if self._row_req[r] is None:
                return r
        return None

    def step(self) -> bool:
        """One scheduler iteration: admit whatever fits, then one decode
        block if anything is decoding. Returns False when nothing could
        make progress (idle, or queued work is blocked on pages). Runs
        without autograd, under the context the engine was built in, set
        for the calling thread alone (``use_sharding_on_thread``): whichever
        thread calls it, no other thread's context changes."""
        with pctx.use_sharding_on_thread(self.ctx):
            return self._step()

    @serving_mode
    def _step(self) -> bool:
        with self.spans.span("step"):
            progressed = False
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    row = self._free_row()
                    if row is None:
                        break
                    plan = self._plan_admission(self._queue[0])
                    if plan is None:
                        break
                    req = self._queue.popleft()
                self._admit(req, row, plan)
                progressed = True
            if self._active.any():
                if self._spec and self._spec_suspended_for > 0:
                    self._spec_suspended_for -= 1
                    # suspended plain blocks run at a LARGER k than the spec
                    # block's iteration count: a speculative engine picks a
                    # small decode_block (each iteration can emit up to K+1
                    # tokens), and plain decode at that k would pay the
                    # per-block host work many times a token
                    self._run_decode_block(k=min(64, self.decode_block * 8))
                    if self._spec_suspended_for == 0:
                        # forget the stale estimate before the re-probe block
                        self._spec_accept_ema = None
                elif self._spec:
                    self._run_spec_block()
                else:
                    self._run_decode_block()
                progressed = True
            return progressed

    def run_until_idle(self) -> None:
        """Drive the scheduler until every submitted request completed."""
        while self._queue or any(r is not None for r in self._row_req):
            if not self.step():
                raise RuntimeError(
                    "engine stalled: queued request cannot be admitted "
                    "(pool too small for the concurrent working set)")

    # ----------------------------------------------------- background thread
    def start(self) -> None:
        """Run the scheduler on a daemon thread (for the serving worker)."""
        if self._thread is not None:
            return
        self._stopping = False

        def loop():
            # the current CUDA device is per thread (autograd's off-switch
            # too: step() enters it itself)
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while not self._stopping:
                try:
                    progressed = self.step()
                except Exception as e:  # a dead scheduler must not strand
                    # blocked result() callers (EngineChat, the worker):
                    # fail everything in flight and queued, then exit
                    logger.exception("engine scheduler failed; "
                                     "failing all pending requests")
                    self._fail_all(e)
                    return
                if not progressed:
                    with self._wake:
                        if not self._queue and not self._active.any() \
                                and not self._stopping:
                            self._wake.wait(timeout=0.1)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            self._failed = exc
            pending = [r for r in self._row_req if r is not None]
            self._row_req = [None] * self.max_rows
            queued = list(self._queue)
            self._queue.clear()
        for req in pending + queued:
            req.error = exc
            req.token_queue.put(None)
            req.finished.set()

    def stop(self) -> None:
        self._stopping = True
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -------------------------------------------------------------- internals
    def _plan_admission(self, req: EngineRequest):
        """Match the prompt's keys (made at submit) against the prefix
        cache and reserve pages; a request that comes without keys is keyed
        here, in the ``digest`` span. Returns (pages, keys,
        n_matched_pages) or None when the pool can't
        cover the request right now; on success cached-prefix pages are
        already acquired and sit at the front of ``pages``."""
        with self.spans.span("plan", req.request_id) as t0:
            ps = self.page_size
            need = -(-(len(req.ids) + req.max_new_tokens + self._spec_slack)
                     // ps)
            pc = self.prefix_cache
            keys = req.keys
            shared: List[int] = []
            if pc is not None:
                if keys is None:          # not keyed at submit
                    with self.spans.span("digest", req.request_id):
                        keys = pc.request_keys(req.ids, req.pos,
                                               req.pixel_values, ps)
                # always leave >=1 prompt token to prefill: the new request
                # needs the last position's logits to sample its first token
                matched = min(pc.match(keys), (len(req.ids) - 1) // ps)
                shared = [pc.acquire(k) for k in keys[:matched]]
            n_new, first = need - len(shared), len(shared)
            fresh = self.allocator.alloc(n_new, first_slot=first)
            if fresh is None and pc is not None:
                # evict parked pages to cover the exact deficit
                for d, k in self.allocator.shortage(n_new, first).items():
                    self.allocator.release(pc.evict(
                        k,
                        pred=lambda p, d=d: self.allocator.shard_of(p) == d))
                fresh = self.allocator.alloc(n_new, first_slot=first)
            if fresh is None:
                for page in shared:           # roll the acquisition back
                    pc.release(page)
                return None
            self.stats["prefix_hit_pages"] += len(shared)
            req.admit_ns = t0
            return shared + fresh, keys, len(shared)

    def _admit(self, req: EngineRequest, row: int, plan) -> None:
        rid = req.request_id
        with self.spans.span("admit", rid):
            pages, keys, matched = plan
            model, llm = self.m.model, self.m.model.llm
            dev = self.device
            MP, CH, ps = self.max_pages_per_row, self.chunk_size, \
                self.page_size
            table_row = np.full(MP, -1, np.int32)
            table_row[:len(pages)] = pages
            consumed = matched * ps       # tokens served by shared pages
            _set_row(self.cache, row, table_row, consumed)
            cached = [(pages[i], keys[i]) for i in range(matched)]

            S = len(req.ids)
            Sf = S - consumed             # suffix left to prefill
            Sp = -(-Sf // CH) * CH
            st = self.stats
            st["admissions"] += 1
            st["queue_wait_ns"] += req.admit_ns - req.submit_ns
            if req.keys is not None:
                st["keyed_at_submit"] += 1
                st["submit_digest_ns"] += req.key_ns
            st["prefix_hit_tokens"] += consumed
            st["prefill_tokens"] += Sf
            st["prefill_pad_tokens"] += Sp - Sf
            req.cached_tokens = consumed
            ids_p = np.pad(req.ids[consumed:], (0, Sp - Sf))[None]
            pos_p = torch.as_tensor(np.pad(req.pos[consumed:], (0, Sp - Sf))[
                None].astype(np.float32), device=dev)
            seg_p = torch.as_tensor(np.pad(np.ones(Sf, np.int32),
                                           (0, Sp - Sf))[None], device=dev)
            ids_t = torch.as_tensor(ids_p, device=dev)
            embeds = llm.tok_embeddings(ids_t)
            n_img = int((ids_p[0] == self.m.img_context_token_id).sum())
            if req.pixel_values is not None and n_img:
                with self.spans.span("pixel_upload", rid):
                    pixels = torch.as_tensor(req.pixel_values).to(
                        device=dev, dtype=embeds.dtype)
                with self.spans.span("vit", rid):
                    vit = internvl_chat.extract_feature(model, self.cfg,
                                                        pixels)
                    # a cached prefix may cover the leading image tokens:
                    # scatter fills the suffix's <IMG_CONTEXT> slots with
                    # the TRAILING feature rows (the leading ones' kv
                    # already sits in the shared pages)
                    tail = vit.reshape(-1, vit.shape[-1])[-n_img:][:, None, :]
                    embeds = internvl_chat.scatter_image_embeds(
                        embeds, ids_t, tail,
                        torch.ones((n_img,), dtype=torch.int32, device=dev),
                        self.m.img_context_token_id)

            last_logits = None
            n_chunks = Sp // CH
            log = self._route_log()
            with self.spans.span("prefill", rid):
                for c in range(n_chunks):
                    sl = slice(c * CH, (c + 1) * CH)
                    last = c == n_chunks - 1   # the first token's chunk
                    with self._routes_into(log if last else None):
                        last_logits = _prefill_row_chunk(
                            llm, self.cfg.llm, self.cache, row,
                            embeds[:, sl], pos_p[:, sl], seg_p[:, sl],
                            min(CH, Sf - c * CH), want_logits=last)
                    st["prefill_chunks"] += 1

            # publish this prompt's freshly written full pages for reuse
            if self.prefix_cache is not None:
                for i in range(matched, S // ps):
                    if self.prefix_cache.register(keys[i], pages[i]):
                        cached.append((pages[i], keys[i]))

            with self.spans.span("first_token", rid):
                tok0 = _first_token(last_logits, self.gc, self._generator)
                if log is not None:   # the read above waited for the chunk
                    at = Sf - (n_chunks - 1) * CH - 1
                    req.routes.append(torch.stack(
                        [idx[at] for idx in log]).cpu().numpy())
            req.first_token_ns = time.time_ns()
            req.first_logits = last_logits
            self._row_req[row] = req
            self._row_pages[row] = pages
            self._row_cached[row] = cached
            self._emit(row, tok0)         # may retire on eos / max_new == 1
            if self._row_req[row] is None:
                return
            self._tok[row] = tok0
            self._pos[row] = float(req.pos[-1]) + 1.0
            self._active[row] = True
            self._rem[row] = req.max_new_tokens - 1
            if self._spec:
                vals = np.zeros(self._ctx_dev.shape[1], np.int32)
                vals[:S] = req.ids
                vals[S] = tok0
                _set_ctx_row(self._ctx_dev, row, vals)
                self._nctx[row] = S + 1
            # the row's state onto the device, where the blocks keep it
            for name, host in (("tok", self._tok), ("pos", self._pos),
                               ("active", self._active), ("rem", self._rem),
                               ("nctx", self._nctx)):
                self._dev[name][row].fill_(host[row].item())

    def _emit(self, row: int, token: int) -> None:
        req = self._row_req[row]
        req.tokens.append(int(token))
        req.token_queue.put(int(token))
        if token in self.gc.eos_token_ids \
                or len(req.tokens) >= req.max_new_tokens:
            self._retire(row)

    def _retire(self, row: int) -> None:
        """Completion: dead-mark the row on device, reclaim pages, finish
        the request."""
        _clear_rows(self.cache, [row])
        self.stats["retired"] += 1
        in_cache = {p for p, _ in self._row_cached[row]}
        for page, _ in self._row_cached[row]:
            self.prefix_cache.release(page)   # parks at refcount 0
        self.allocator.release(
            [p for p in self._row_pages[row] if p not in in_cache])
        self._row_pages[row] = []
        self._row_cached[row] = []
        self._active[row] = False
        self._dev["active"][row].fill_(False)
        req, self._row_req[row] = self._row_req[row], None
        req._text = self.m._decode(np.asarray(req.tokens, np.int64),
                                   len(req.tokens))
        req.token_queue.put(None)
        req.finished.set()

    def _route_log(self) -> Optional[list]:
        """A list for the MoE layers' choices when routes are recorded."""
        return [] if self._mla and self.record_routes else None

    @contextlib.contextmanager
    def _routes_into(self, log: Optional[list]):
        """The decoder's MoE layers append their choices to ``log`` (none
        when it is None) inside the block."""
        if log is None:
            yield
            return
        llm = self.m.model.llm
        llm.route_log = log
        try:
            yield
        finally:
            llm.route_log = None

    def _harvest(self, emitted: torch.Tensor,
                 routes: Optional[list] = None):
        """The block's one read of the device: the emitted tokens and the
        rows' state in one tensor (with the MoE counters and ``routes``, the
        block's logged expert choices, when there are any). Refreshes the
        host mirrors and returns emitted (B, n) as numpy, and the choices as
        (n, MoE layers, B, k), or None."""
        d = self._dev
        chosen = None
        with self.spans.span("harvest"):
            state = torch.cat(
                [emitted, d["tok"][:, None],
                 d["pos"].view(torch.int32)[:, None],
                 d["active"].to(torch.int32)[:, None], d["rem"][:, None],
                 d["nctx"][:, None]], dim=1)
            if not self._mla:
                host = state.cpu().numpy()
            else:  # the expert counters (and choices) ride in the same read
                counts = self.m.model.llm.moe_counts
                parts = [state.reshape(-1), counts.view(torch.int32)]
                if routes:
                    parts.append(torch.stack(routes).view(torch.int32
                                                          ).reshape(-1))
                flat = torch.cat(parts).cpu().numpy()
                host = flat[:state.numel()].reshape(state.shape)
                rest = np.frombuffer(flat[state.numel():].tobytes(), np.int64)
                self.stats.update(zip(MOE_STATS,
                                      rest[:len(MOE_STATS)].tolist()))
                if routes:
                    n, k = emitted.shape[1], routes[0].shape[-1]
                    chosen = rest[len(MOE_STATS):].reshape(
                        n, len(routes) // n, -1, k)
        n = emitted.shape[1]
        self._tok = host[:, n].copy()
        self._pos = host[:, n + 1].copy().view(np.float32)
        self._active = host[:, n + 2] != 0
        self._rem = host[:, n + 3].copy()
        self._nctx = host[:, n + 4].copy()
        return host[:, :n], chosen

    def _run_decode_block(self, k: Optional[int] = None) -> None:
        d = self._dev
        k = k or self.decode_block
        log = self._route_log()
        with self.spans.span("decode_block"):
            with self.spans.span("decode_launch"), self._routes_into(log):
                emitted = _decode_block(
                    self.m.model.llm, self.cfg.llm, self.gc, self.cache,
                    d["tok"], d["pos"], d["active"], d["rem"], self._eos,
                    self._generator, k)
                if self._spec:
                    # suspended-speculation mode: keep the draft history
                    # current
                    _append_ctx(self._ctx_dev, d["nctx"], emitted)
            self.stats["decode_blocks"] += 1
            self.stats["decode_steps"] += k
            self._drain_emitted(*self._harvest(emitted, log))

    def _run_spec_block(self) -> None:
        """Speculative counterpart of :meth:`_run_decode_block`: each of
        ``decode_block`` iterations verifies K+1 tokens per row in one
        forward, so a block emits between decode_block and
        decode_block*(K+1) tokens per active row."""
        d = self._dev
        with self.spans.span("decode_block"):
            n_act = int(self._active.sum())
            with self.spans.span("decode_launch"):
                out = _spec_block(
                    self.m.model.llm, self.cfg.llm, self.gc, self.cache,
                    self._ctx_dev, d["nctx"], d["tok"], d["pos"],
                    d["active"], d["rem"], self._eos, self.decode_block)
            emitted, _ = self._harvest(out)
            accepted = int((emitted >= 0).sum())
            self.stats["decode_blocks"] += 1
            self.stats["decode_steps"] += self.decode_block
            self.stats["spec_forwards"] = \
                self.stats.get("spec_forwards", 0) + int(self.decode_block)
            self.stats["spec_accepted"] = \
                self.stats.get("spec_accepted", 0) + accepted
            # adaptive suspend (see __init__): acceptance per verify forward
            # per row that was active when the block started. A row that
            # finishes inside the block stays in the denominator for the
            # block's remaining forwards, as in the JAX engine, which biases
            # the estimate low (towards suspending) near the end of
            # requests.
            if n_act:
                accept = float(accepted) / (self.decode_block * n_act)
                ema = self._spec_accept_ema
                self._spec_accept_ema = accept if ema is None \
                    else 0.5 * ema + 0.5 * accept
                if self._spec_accept_ema < self.spec_min_accept:
                    self._spec_suspended_for = self.spec_reprobe_blocks
                    self.stats["spec_suspends"] = \
                        self.stats.get("spec_suspends", 0) + 1
            self._drain_emitted(emitted)

    def _drain_emitted(self, emitted: np.ndarray,
                       routes: Optional[np.ndarray] = None) -> None:
        with self.spans.span("drain"):
            for row in range(self.max_rows):
                if self._row_req[row] is None:
                    continue
                for i, t in enumerate(emitted[row]):
                    if t < 0 or self._row_req[row] is None:
                        continue
                    if routes is not None:
                        self._row_req[row].routes.append(routes[i, :, row])
                    self._emit(row, int(t))
                # budget exhausted without a stop token mid-block
                if self._row_req[row] is not None and not self._active[row]:
                    self._retire(row)


class EngineChat:
    """``ChatModel.chat``-compatible facade over a shared InferenceEngine.

    Drop-in for any per-sample consumer of ``ChatModel``: each ``chat`` call
    submits to the engine and blocks on the request's result, so N caller
    threads batch into one continuous decode (weight reads shared by the
    rows) instead of N sequential generations. Greedy-only: sampling is an
    engine-wide setting; beam requests must use the plain ChatModel. All
    non-``chat`` attributes (``load_pixels``, ``cfg``, ``tokenizer``, ...)
    delegate to the wrapped model.
    """

    def __init__(self, chat_model, *, max_rows: int = 8,
                 max_len: int = 8192, **engine_kwargs):
        self._m = chat_model
        self.engine = InferenceEngine(chat_model, max_rows=max_rows,
                                      max_len=max_len, **engine_kwargs)
        self.engine.start()

    def __getattr__(self, name):
        return getattr(self._m, name)

    def chat(self, pixel_values, question,
             generation_config: Optional[GenerationConfig] = None,
             history=None, return_history: bool = False,
             num_patches_list=None, rope_pos_id_version: Optional[str] = None,
             rope_pos_id_stride: Optional[int] = None, verbose: bool = False):
        gc = generation_config or GenerationConfig()
        if gc.do_sample or gc.num_beams > 1:
            raise ValueError(
                "EngineChat decodes greedily on the shared engine; use the "
                "plain ChatModel for sampling/beam generation")
        if history is None and pixel_values is not None \
                and "<image>" not in question:
            question = "<image>\n" + question  # history keeps the marker
        req = self.engine.submit_chat(
            pixel_values, question, max_new_tokens=gc.max_new_tokens,
            history=history, num_patches_list=num_patches_list,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)
        text = req.result()
        if return_history:
            return text, (list(history or []) + [(question, text)])
        return text

    def stop(self):
        self.engine.stop()
