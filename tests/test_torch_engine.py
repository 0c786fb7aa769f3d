"""The port's continuous-batching engine (``v2pe_tpu_torch/serve/engine.py``)
against the JAX engine on the CPU, in fp32 on a small model.

Every test of ``tests/test_engine.py`` (the mesh one aside: one card, no
mesh arm) has its counterpart here, run through both engines over the same
weights: the port's texts must equal its own isolated ``chat`` and the JAX
engine's texts, token for token, and the engines' ``stats`` must be equal.
Further: the host classes against their originals, int8 / int4 pools, the
speculative engine with its adaptive suspend, rows that end on a page
boundary, sampling for what it promises (seeded runs repeat, top-k support),
a quantized model on the scheduler thread, and the HTTP worker's routes
through the engine against the JAX worker's.

Tolerances: none. Tokens, texts, stats and page accounting are compared
exactly; the models are fp32 and their greedy margins far above the
difference between the frameworks' sums.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.serve import engine as jengine
from v2pe_tpu.serve.worker import ModelWorker as JaxModelWorker
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.serve import engine as tengine
from v2pe_tpu_torch.serve.worker import ModelWorker

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config

QUESTIONS = ["Describe the picture.", "What color?", "Count the objects."]


@pytest.fixture(scope="module")
def pair():
    """(JAX ChatModel, port ChatModel) over the same fp32 weights; the wqkv
    kernel is sharpened so that the greedy tokens depend on the cache."""
    tok = _toy_tokenizer()
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=32,
                      intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        max_dynamic_patch=2)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    pcfg = port_config(cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg)
    return (JaxChatModel(params, cfg, tok, attn_impl="jnp"),
            ChatModel(model, pcfg, tok))


def _engines(pair, gc=None, **kw):
    """A JAX engine and a port engine of the same geometry."""
    kw.setdefault("max_rows", 2)
    kw.setdefault("max_len", 1024)
    kw.setdefault("page_size", 8)
    kw.setdefault("chunk_size", 64)
    kw.setdefault("decode_block", 4)
    jgc = None if gc is None else JaxGenerationConfig(**gc)
    tgc = None if gc is None else GenerationConfig(**gc)
    return (jengine.InferenceEngine(pair[0], generation_config=jgc, **kw),
            tengine.InferenceEngine(pair[1], generation_config=tgc, **kw))


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), np.uint8))


def _same(jreqs, treqs, jeng, teng):
    """Both engines emitted the same tokens and texts and count the same."""
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        assert tr.result(timeout=0) == jr.result(timeout=0)
    assert {k: teng.stats[k] for k in jeng.stats} == jeng.stats


def _run_both(pair, submits, gc=None, **kw):
    """Submit the same requests (a list of (method, args, kwargs)) to both
    engines and run each until idle: (jax reqs, port reqs, engines)."""
    jeng, teng = _engines(pair, gc, **kw)
    out = []
    for eng in (jeng, teng):
        reqs = [getattr(eng, m)(*a, **k) for m, a, k in submits]
        eng.run_until_idle()
        out.append(reqs)
    _same(out[0], out[1], jeng, teng)
    return out[0], out[1], jeng, teng


# ------------------------------------------------------------- host classes


def test_page_allocator():
    a = tengine.PageAllocator(8)
    assert a.available == 7                 # page 0 reserved
    p1 = a.alloc(3)
    p2 = a.alloc(4)
    assert a.alloc(1) is None
    assert 0 not in p1 + p2 and len(set(p1 + p2)) == 7
    a.release(p1)
    assert a.available == 3
    assert sorted(a.alloc(3)) == sorted(p1)


def test_page_allocator_sharded():
    a = tengine.PageAllocator(16, n_shards=4)  # 4 pages/shard, local 0 null
    assert a.available == 12
    pages = a.alloc(8, first_slot=0)        # slots 0..7 round-robin
    assert [a.shard_of(p) for p in pages] == [0, 1, 2, 3, 0, 1, 2, 3]
    more = a.alloc(2, first_slot=8)
    assert [a.shard_of(p) for p in more] == [0, 1]
    assert a.alloc(5, first_slot=0) is None
    assert a.shortage(5, 0) == {0: 2, 1: 1}
    a.release(pages)
    assert a.alloc(5, first_slot=0) is not None


@pytest.mark.parametrize("n_shards", [1, 4])
def test_page_allocator_follows_the_jax_allocator(n_shards):
    """The same random sequence of allocations and releases hands out the
    same pages in both packages."""
    rng = np.random.default_rng(n_shards)
    ja = jengine.PageAllocator(32, n_shards=n_shards)
    ta = tengine.PageAllocator(32, n_shards=n_shards)
    held = []
    for _ in range(60):
        if held and rng.random() < 0.4:
            pages = held.pop(int(rng.integers(len(held))))
            ja.release(pages)
            ta.release(pages)
        else:
            n, first = int(rng.integers(1, 7)), int(rng.integers(0, 4))
            assert ta.shortage(n, first) == ja.shortage(n, first)
            got, want = ta.alloc(n, first), ja.alloc(n, first)
            assert got == want
            if got is not None:
                held.append(got)
        assert ta.available == ja.available


def test_prefix_cache_follows_the_jax_cache():
    """chain_keys hashes ids, float32 positions and the seed as JAX's does;
    match / acquire / register / release / evict keep the same books."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 100, 37)
    pos = np.arange(37) * 0.5
    seed = b"pixels"
    keys = tengine.PrefixCache.chain_keys(ids, pos, 8, seed)
    assert keys == jengine.PrefixCache.chain_keys(ids, pos, 8, seed)
    assert len(keys) == 4 and len(set(keys)) == 4
    assert keys != tengine.PrefixCache.chain_keys(ids, pos * 2, 8, seed)
    assert keys != tengine.PrefixCache.chain_keys(ids, pos, 8, b"other")
    jc, tc = jengine.PrefixCache(), tengine.PrefixCache()
    for c in (jc, tc):
        assert c.match(keys) == 0
        for i, k in enumerate(keys[:3]):
            assert c.register(k, 10 + i)
        assert not c.register(keys[0], 99)
        assert c.match(keys) == 3
        assert c.acquire(keys[0]) == 10
        for page in (10, 10, 11, 12):
            c.release(page)
    assert tc.evictable == jc.evictable == 3
    assert tc.evict(2) == jc.evict(2) == [10, 11]
    assert tc.match(keys) == jc.match(keys) == 0  # the chain's head is gone
    assert tc.hits == jc.hits == 1


# ------------------------------------------- counterparts of test_engine.py


def test_engine_matches_isolated_chat(pair):
    """3 requests through a 2-row engine (the third queues until a row
    frees) reproduce chat()'s greedy output per request, and the JAX
    engine's."""
    pv, _ = pair[1].load_pixels(_image(0, 64, 80))
    gc = GenerationConfig(max_new_tokens=6)
    refs = [pair[1].chat(pv, QUESTIONS[0], gc),
            pair[1].chat(None, QUESTIONS[1], gc),
            pair[1].chat(None, QUESTIONS[2], gc)]
    kw = dict(max_new_tokens=6)
    _, treqs, _, _ = _run_both(pair, [
        ("submit_chat", (pv, QUESTIONS[0]), kw),
        ("submit_chat", (None, QUESTIONS[1]), kw),
        ("submit_chat", (None, QUESTIONS[2]), kw)])
    assert [r.result(timeout=0) for r in treqs] == refs


def test_engine_mid_stream_admission(pair):
    """A request submitted while another is mid-decode is admitted into a
    free row without disturbing the in-flight generation."""
    gc = GenerationConfig(max_new_tokens=8)
    refs = [pair[1].chat(None, q, gc) for q in QUESTIONS[1:]]
    jeng, teng = _engines(pair)
    out = []
    for eng in (jeng, teng):
        ra = eng.submit_chat(None, QUESTIONS[1], max_new_tokens=8)
        assert eng.step()                  # admit A + first decode block
        assert eng._active.any()
        rb = eng.submit_chat(None, QUESTIONS[2], max_new_tokens=8)
        eng.run_until_idle()
        out.append([ra, rb])
    _same(out[0], out[1], jeng, teng)
    assert [r.result(timeout=0) for r in out[1]] == refs


def test_engine_reclaims_pages(pair):
    jeng, teng = _engines(pair)
    total = teng.allocator.available
    assert total == jeng.allocator.available
    for eng in (jeng, teng):
        reqs = [eng.submit_chat(None, q, max_new_tokens=5)
                for q in QUESTIONS]
        eng.run_until_idle()
        assert all(r.finished.is_set() for r in reqs)
        # every page is back on the free list or parked in the prefix cache
        assert eng.allocator.available + eng.prefix_cache.evictable == total
    assert teng.allocator.available == jeng.allocator.available
    assert bool((teng.cache.page_table == -1).all())
    assert bool((teng.cache.lengths == 0).all())
    assert not teng._dev["active"].any()
    # rows reusable: a fourth request still works
    r4 = teng.submit_chat(None, QUESTIONS[0], max_new_tokens=5)
    j4 = jeng.submit_chat(None, QUESTIONS[0], max_new_tokens=5)
    teng.run_until_idle()
    jeng.run_until_idle()
    _same([j4], [r4], jeng, teng)


def test_engine_row_reuse_matches(pair):
    """Requests served on REUSED rows (after earlier retirements wrote and
    freed the same physical pages) still match isolated runs: stale
    contents past a row's length are never read."""
    gc = GenerationConfig(max_new_tokens=7)
    refs = [pair[1].chat(None, q, gc) for q in QUESTIONS * 2]
    _, treqs, _, _ = _run_both(
        pair, [("submit_chat", (None, q), dict(max_new_tokens=7))
               for q in QUESTIONS * 2])
    assert [r.result(timeout=0) for r in treqs] == refs


def test_engine_streaming_and_thread(pair):
    """Background-thread mode: the token queue streams and result() blocks
    until completion; the thread runs every device call without autograd."""
    teng = _engines(pair)[1]
    teng.start()
    try:
        req = teng.submit_chat(None, QUESTIONS[0], max_new_tokens=5)
        text = req.result(timeout=120)
        assert req.finished.is_set()
        toks = []
        while True:
            t = req.token_queue.get(timeout=10)
            if t is None:
                break
            toks.append(t)
        assert toks == req.tokens and 0 < len(toks) <= 5
        assert text == pair[1]._decode(np.asarray(toks), len(toks))
        assert text == pair[1].chat(None, QUESTIONS[0],
                                    GenerationConfig(max_new_tokens=5))
        assert not teng.cache.lengths.requires_grad
    finally:
        teng.stop()
    assert teng._thread is None


def test_engine_rejects_oversized(pair):
    teng = _engines(pair, max_len=64)[1]
    with pytest.raises(ValueError, match="max_len"):
        teng.submit(np.arange(10), np.arange(10, dtype=np.float32),
                    max_new_tokens=60)
    small = tengine.InferenceEngine(pair[1], max_rows=1, max_len=64,
                                    page_size=8, pool_tokens=16)
    with pytest.raises(ValueError, match="never fit"):
        small.submit(np.arange(10), np.arange(10, dtype=np.float32),
                     max_new_tokens=20)


def test_prefix_cache_hit_and_exactness(pair):
    """An identical prompt resubmitted after completion reuses the parked
    prefix pages (fewer prefill chunks' worth of tokens) and still produces
    the exact isolated-chat output."""
    gc = GenerationConfig(max_new_tokens=6)
    hist = [("Please remember this long setup. " * 3, "Noted.")]
    ref = pair[1].chat(None, QUESTIONS[0], gc, history=hist)
    jeng, teng = _engines(pair)
    out = []
    for eng in (jeng, teng):
        r1 = eng.submit_chat(None, QUESTIONS[0], max_new_tokens=6,
                             history=hist)
        eng.run_until_idle()
        assert eng.stats["prefix_hit_pages"] == 0
        r2 = eng.submit_chat(None, QUESTIONS[0], max_new_tokens=6,
                             history=hist)
        eng.run_until_idle()
        assert eng.stats["prefix_hit_pages"] == \
            (len(r2.ids) - 1) // eng.page_size
        out.append([r1, r2])
    _same(out[0], out[1], jeng, teng)
    assert [r.result(timeout=0) for r in out[1]] == [ref, ref]


def test_prefix_cache_shared_while_active(pair):
    """Two same-prefix requests IN FLIGHT TOGETHER share physical pages
    (their tables name the same page; the store never lands in it) and both
    match their isolated outputs."""
    gc = GenerationConfig(max_new_tokens=12)
    hist = [("Shared system preamble, quite long indeed. " * 2, "Ok.")]
    refs = [pair[1].chat(None, q, gc, history=hist) for q in QUESTIONS[:2]]
    jeng, teng = _engines(pair)
    out = []
    for eng in (jeng, teng):
        ra = eng.submit_chat(None, QUESTIONS[0], max_new_tokens=12,
                             history=hist)
        assert eng.step()
        rb = eng.submit_chat(None, QUESTIONS[1], max_new_tokens=12,
                             history=hist)
        if eng is teng:
            assert eng.step()
            table = eng.cache.page_table.numpy()
            shared = set(table[0][table[0] >= 0]) & \
                set(table[1][table[1] >= 0])
            assert len(shared) == eng.stats["prefix_hit_pages"] > 0
        eng.run_until_idle()
        out.append([ra, rb])
    _same(out[0], out[1], jeng, teng)
    assert [r.result(timeout=0) for r in out[1]] == refs


def test_prefix_cache_respects_positions(pair):
    """Same token ids with different V2PE positions must NOT share pages
    (positions shape the stored rotary-applied keys)."""
    ids = np.arange(5, 45) % 30 + 4
    pos = np.arange(40, dtype=np.float32)
    jeng, teng = _engines(pair)
    out = []
    for eng in (jeng, teng):
        reqs = [eng.submit(ids, pos, max_new_tokens=4)]
        eng.run_until_idle()
        reqs.append(eng.submit(ids, pos * 0.5, max_new_tokens=4))
        eng.run_until_idle()
        assert eng.stats["prefix_hit_pages"] == 0
        reqs.append(eng.submit(ids, pos, max_new_tokens=4))  # a repeat hits
        eng.run_until_idle()
        assert eng.stats["prefix_hit_pages"] == \
            (len(ids) - 1) // eng.page_size
        out.append(reqs)
    _same(out[0], out[1], jeng, teng)
    assert out[1][0].tokens == out[1][2].tokens  # the hit equals the cold run


def test_prefix_cache_image_content_in_identity(pair):
    """Identical prompt text with a DIFFERENT image must not reuse pages,
    each output matches its isolated run, and the same image again reuses
    the prefix across the image tokens: the ViT features of the suffix's
    image slots are scattered from the tail."""
    rng = np.random.RandomState(3)
    from PIL import Image

    img1 = Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8))
    img2 = Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8))
    gc = GenerationConfig(max_new_tokens=5)
    pv1, _ = pair[1].load_pixels(img1)
    pv2, _ = pair[1].load_pixels(img2)
    refs = [pair[1].chat(pv1, QUESTIONS[0], gc),
            pair[1].chat(pv2, QUESTIONS[0], gc)]
    jeng, teng = _engines(pair)
    out = []
    for eng in (jeng, teng):
        reqs = []
        for pv in (pv1, pv2):
            reqs.append(eng.submit_chat(pv, QUESTIONS[0], max_new_tokens=5))
            eng.run_until_idle()
        assert eng.stats["prefix_hit_pages"] == 0
        reqs.append(eng.submit_chat(pv1, QUESTIONS[0], max_new_tokens=5))
        eng.run_until_idle()
        assert eng.stats["prefix_hit_pages"] > 0
        out.append(reqs)
    _same(out[0], out[1], jeng, teng)
    assert [r.result(timeout=0) for r in out[1]] == refs + refs[:1]


def test_prefix_cache_eviction_under_pressure(pair):
    """Parked prefix pages are evicted when the free list runs dry; the
    engine keeps serving correctly."""
    gc = GenerationConfig(max_new_tokens=4)
    prompts = [f"Topic {i}: tell me something interesting." for i in range(4)]
    refs = [pair[1].chat(None, p, gc) for p in prompts]
    jeng, teng = _engines(pair, max_rows=1, max_len=256,
                          pool_tokens=160)  # 20 usable pages of 8
    out = []
    for eng in (jeng, teng):
        reqs = []
        for p in prompts:                # sequential: each parks its pages
            reqs.append(eng.submit_chat(None, p, max_new_tokens=4))
            eng.run_until_idle()
        out.append(reqs)
        total = eng.allocator.n_pages - 1
        assert eng.allocator.available + eng.prefix_cache.evictable == total
    _same(out[0], out[1], jeng, teng)
    assert [r.result(timeout=0) for r in out[1]] == refs
    assert teng.prefix_cache.evictable == jeng.prefix_cache.evictable


def test_engine_chat_facade_matches_chat(pair):
    """EngineChat.chat == ChatModel.chat (greedy), incl. image turns,
    history threading and attribute delegation; caller threads through the
    facade get the answers sequential chat gives."""
    tchat = pair[1]
    img = _image(1, 60, 72)
    pv, _ = tchat.load_pixels(img)
    gc = GenerationConfig(max_new_tokens=5)
    ec = tengine.EngineChat(tchat, max_rows=2, max_len=1024, page_size=8,
                            chunk_size=64, decode_block=4)
    try:
        assert ec.cfg is tchat.cfg
        pv2, _ = ec.load_pixels(img)
        np.testing.assert_array_equal(pv2, pv)
        ref = tchat.chat(pv, QUESTIONS[0], gc)
        got, hist = ec.chat(pv, QUESTIONS[0], gc, return_history=True)
        assert got == ref and hist[-1][1] == ref
        assert ec.chat(None, "And then?", gc, history=hist) == \
            tchat.chat(None, "And then?", gc, history=hist)
        for bad in (GenerationConfig(do_sample=True),
                    GenerationConfig(num_beams=2)):
            with pytest.raises(ValueError):
                ec.chat(None, "q", bad)
        answers = {}

        def ask(q):
            answers[q] = ec.chat(None, q, gc)

        threads = [threading.Thread(target=ask, args=(q,))
                   for q in QUESTIONS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert answers == {q: tchat.chat(None, q, gc) for q in QUESTIONS}
    finally:
        ec.stop()


def test_engine_many_caller_threads(pair):
    """More caller threads than cores, with the interpreter switching
    threads every 10 us, submit through one EngineChat while its scheduler
    thread admits and retires: every caller gets the answer sequential chat
    gives, no request is lost and every page comes back."""
    import os
    import sys

    tchat = pair[1]
    gc = GenerationConfig(max_new_tokens=4)
    questions = [f"{q} ({i})" for i in range(4) for q in QUESTIONS]
    want = {q: tchat.chat(None, q, gc) for q in questions}
    ec = tengine.EngineChat(tchat, max_rows=3, max_len=256, page_size=8,
                            chunk_size=64, decode_block=2)
    total = ec.engine.allocator.available
    answers, lock = {}, threading.Lock()

    def ask(q):
        text = ec.chat(None, q, gc)
        with lock:
            answers[q] = text

    n_threads = max(len(questions), 2 * (os.cpu_count() or 1))
    threads = [threading.Thread(target=ask, args=(questions[i % len(
        questions)],)) for i in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        ec.stop()
    assert answers == want
    eng = ec.engine
    assert eng.allocator.available + eng.prefix_cache.evictable == total
    assert not eng._queue and all(r is None for r in eng._row_req)
    with pytest.raises(ValueError, match="shards"):
        tengine.PageAllocator(10, n_shards=4)


def test_engine_scheduler_failure_fails_pending(pair):
    """If the scheduler loop dies, blocked result() callers get a
    RuntimeError instead of hanging for ever."""
    teng = _engines(pair)[1]

    def boom():
        raise RuntimeError("injected scheduler failure")

    teng.step = boom
    req = teng.submit_chat(None, "hello", max_new_tokens=4)  # queued first
    teng.start()
    with pytest.raises(RuntimeError, match="failed"):
        req.result(timeout=30)
    assert req.finished.is_set()
    with pytest.raises(RuntimeError, match="failed"):
        teng.submit_chat(None, "again", max_new_tokens=4)
    teng.stop()
    with pytest.raises(RuntimeError, match="stalled"):
        blocked = tengine.InferenceEngine(pair[1], max_rows=1, max_len=64,
                                          page_size=8, pool_tokens=64)
        blocked.allocator.alloc(6)       # someone else holds the pages
        blocked.submit(np.arange(20), np.arange(20, dtype=np.float32),
                       max_new_tokens=8)
        blocked.run_until_idle()


# ------------------------------------------------------- beyond those tests


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_engine_quantized_pool_matches_jax(pair, kv):
    """Five requests through two rows over a quantized pool, one of them a
    repeat that hits the prefix cache: the JAX engine's tokens and stats."""
    hist = [("A preamble that spans a few pages of eight tokens. ", "Yes.")]
    submits = [("submit_chat", (None, q),
                dict(max_new_tokens=6, history=hist))
               for q in QUESTIONS + QUESTIONS[:2]]
    _, treqs, _, teng = _run_both(pair, submits, kv_dtype=kv)
    assert teng.cache.kv_bits == (4 if kv == "int4" else 8)
    assert teng.stats["prefix_hit_pages"] > 0
    assert treqs[0].tokens == treqs[3].tokens


@pytest.mark.parametrize("prompt,new", [(11, 5), (16, 8), (9, 7)])
def test_engine_rows_ending_on_a_page_boundary(pair, prompt, new):
    """prompt + max_new a multiple of the page (the row fills its last
    reserved page: the clamped store slot), a prompt that is whole pages,
    and a row whose last token opens a page, beside a longer neighbour
    that keeps decoding through the same blocks."""
    rng = np.random.default_rng(prompt)
    ids = rng.integers(4, 60, prompt)
    # (11, 5): the table is as wide as the row's 16 tokens and no wider
    n_other, new_other, max_len = (13, 3, 16) if prompt == 11 else (21, 13,
                                                                    64)
    other = rng.integers(4, 60, n_other)
    submits = [("submit", (ids, np.arange(prompt, dtype=np.float32)),
                dict(max_new_tokens=new)),
               ("submit", (other, np.arange(n_other, dtype=np.float32)),
                dict(max_new_tokens=new_other))]
    _, treqs, _, teng = _run_both(pair, submits, gc=dict(eos_token_ids=(1,)),
                                  max_len=max_len)
    assert [len(r.tokens) for r in treqs] == [new, new_other]
    # alone, the first request gives the same tokens
    solo = _engines(pair, gc=dict(eos_token_ids=(1,)), max_len=64)[1]
    r = solo.submit(ids, np.arange(prompt, dtype=np.float32),
                    max_new_tokens=new)
    solo.run_until_idle()
    assert r.tokens == treqs[0].tokens


def _copy_prompt():
    """A prompt whose greedy continuation can be drafted from itself."""
    base = np.array([5, 9, 12, 7, 30, 22, 41, 8], np.int64)
    return np.concatenate([base, base, base, base[:5]])


@pytest.mark.parametrize("kv", [None, "int4"])
def test_engine_speculative_matches_plain_and_jax(pair, kv):
    """speculative_k=3: the tokens of the plain engine, and the JAX
    speculative engine's tokens and stats (forwards, accepted, suspends:
    the acceptance estimate keeps JAX's arithmetic)."""
    rng = np.random.default_rng(7)
    prompts = [_copy_prompt(), rng.integers(4, 60, 19), _copy_prompt()[3:]]
    submits = [("submit", (p, np.arange(len(p), dtype=np.float32)),
                dict(max_new_tokens=12)) for p in prompts]
    plain = _engines(pair, kv_dtype=kv)[1]
    want = [plain.submit(*a, **k) for _, a, k in submits]
    plain.run_until_idle()
    gc = dict(speculative_k=3, speculative_ngram=2)
    _, treqs, jeng, teng = _run_both(pair, submits, gc=gc, kv_dtype=kv,
                                     decode_block=2, spec_reprobe_blocks=2)
    assert [r.tokens for r in treqs] == [r.tokens for r in want]
    assert teng.stats["spec_forwards"] > 0
    assert teng.stats.get("spec_suspends", 0) == \
        jeng.stats.get("spec_suspends", 0)
    assert teng._spec_suspended_for == jeng._spec_suspended_for
    np.testing.assert_array_equal(teng._nctx, jeng._nctx)
    for bad in (dict(speculative_k=2, do_sample=True),
                dict(speculative_k=16)):
        with pytest.raises(ValueError):
            tengine.InferenceEngine(pair[1],
                                    generation_config=GenerationConfig(**bad))


def test_engine_speculative_suspends_and_reprobes(pair):
    """Drafts that never hit: the engine suspends speculation, decodes
    plain blocks (keeping the draft history current) and probes again, in
    step with the JAX engine."""
    rng = np.random.default_rng(11)
    p = rng.permutation(60)[:23] + 4
    submits = [("submit", (p, np.arange(23, dtype=np.float32)),
                dict(max_new_tokens=40))]
    gc = dict(speculative_k=2, eos_token_ids=(1,))
    _, treqs, jeng, teng = _run_both(
        pair, submits, gc=gc, decode_block=1, spec_min_accept=2.5,
        spec_reprobe_blocks=1)
    assert teng.stats["spec_suspends"] == jeng.stats["spec_suspends"] >= 2
    plain = _engines(pair, gc=dict(eos_token_ids=(1,)))[1]
    r = plain.submit(*submits[0][1], **submits[0][2])
    plain.run_until_idle()
    assert treqs[0].tokens == r.tokens and len(r.tokens) == 40


def test_engine_sampling_is_seeded_and_filtered(pair):
    """do_sample draws from the engine's torch.Generator: the same seed
    repeats the run, another seed need not; top_k=1 is greedy."""
    ids = np.arange(5, 25)
    pos = np.arange(20, dtype=np.float32)

    def run(seed, **gc):
        eng = tengine.InferenceEngine(
            pair[1], max_rows=2, max_len=128, page_size=8, chunk_size=64,
            decode_block=4, generation_config=GenerationConfig(
                eos_token_ids=(1,), **gc),
            generator=torch.Generator().manual_seed(seed))
        reqs = [eng.submit(ids, pos, max_new_tokens=10) for _ in range(2)]
        eng.run_until_idle()
        return [r.tokens for r in reqs]

    sample = dict(do_sample=True, temperature=1.5)
    a, b = run(3, **sample), run(3, **sample)
    assert a == b and a[0] != a[1]       # two rows, two streams
    assert run(4, **sample) != a
    greedy = run(0)
    assert run(5, do_sample=True, temperature=0.7, top_k=1) == greedy
    assert greedy[0] == greedy[1]


def test_engine_thread_serves_a_quantized_model(pair):
    """int8 weights refuse a gradient; the scheduler thread must therefore
    run every step without autograd (it is off per thread, not per
    process)."""
    qchat = ChatModel(pair[1].model, pair[1].cfg, pair[1].tokenizer,
                      weights_dtype="int8")
    gc = GenerationConfig(max_new_tokens=5)
    ref = qchat.chat(None, QUESTIONS[1], gc)
    ec = tengine.EngineChat(qchat, max_rows=2, max_len=256, page_size=8,
                            chunk_size=64, decode_block=4)
    try:
        assert torch.is_grad_enabled()
        assert ec.chat(None, QUESTIONS[1], gc) == ref
    finally:
        ec.stop()


# ------------------------------------------------------------------- worker


@pytest.fixture(scope="module")
def servers(pair):
    """The JAX worker and the port's, each over its engine, on free local
    ports."""
    jeng, teng = _engines(pair)
    urls, running = [], []
    for worker in (JaxModelWorker(pair[0], model_name="tiny", engine=jeng),
                   ModelWorker(pair[1], model_name="tiny", engine=teng)):
        server = worker.make_server(host="127.0.0.1", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        urls.append(f"http://127.0.0.1:{server.server_address[1]}")
        running.append(server)
    yield urls
    for server in running:
        server.shutdown()
        server.server_close()
    jeng.stop()
    teng.stop()


def _post(url, body, raw=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
        return data if raw else json.loads(data)


def _strip_ids(record):
    return {k: v for k, v in record.items() if k not in ("id", "created")}


def test_worker_stream_through_the_engine_matches_jax(servers):
    from v2pe_tpu_torch.serve.mm_utils import image_to_base64

    payloads = [
        {"prompt": "<|im_start|>user\nCount to three.<|im_end|>"
                   "<|im_start|>assistant\n", "max_new_tokens": 12,
         "temperature": 0.0},
        {"prompt": "<|im_start|>user\n<image>\nWhat is this?<|im_end|>"
                   "<|im_start|>assistant\n",
         "images": [image_to_base64(_image(0, 60, 60))],
         "max_new_tokens": 6, "temperature": 0.0}]
    for payload in payloads:
        want, got = ([json.loads(c) for c in _post(
            u + "/worker_generate_stream", payload, raw=True).split(b"\0")
            if c] for u in servers)
        assert got == want
        assert got and all(c["error_code"] == 0 for c in got)


def test_worker_openai_routes_through_the_engine_match_jax(servers):
    body = {"model": "tiny", "messages": [
        {"role": "system", "content": "Be terse."},
        {"role": "user", "content": "Describe a tree."},
        {"role": "assistant", "content": "Green."},
        {"role": "user", "content": "Again?"}],
        "max_tokens": 6, "temperature": 0.0}
    want, got = (_post(u + "/v1/chat/completions", body) for u in servers)
    assert _strip_ids(got) == _strip_ids(want)
    assert got["usage"]["completion_tokens"] <= 6

    def events(url):
        raw = _post(url + "/v1/chat/completions", {**body, "stream": True},
                    raw=True)
        lines = [ln[len("data: "):] for ln in raw.decode().split("\n\n")
                 if ln.startswith("data: ")]
        assert lines[-1] == "[DONE]"
        return [_strip_ids(json.loads(x)) for x in lines[:-1]]

    want, got = (events(u) for u in servers)
    assert got == want
    assert got[-1]["choices"][0]["finish_reason"] in ("stop", "length")
