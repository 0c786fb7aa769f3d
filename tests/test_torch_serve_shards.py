"""Serving over a sequence-sharded paged pool held on one card (the port's
form of JAX's ``seq`` mesh axis: ``ShardingContext(seq_shards=n)`` in a
world of 1), against the unsharded JAX run on the CPU.

JAX's own tests of these paths run under an 8-device mesh and are slow
(tests/test_decode_mesh.py:210,255, tests/test_chunked_prefill.py:79,109,
tests/test_engine.py:251, tests/test_quantized_weights.py:448); their
check is that the mesh run equals the unsharded one, so the port's sharded
runs are held to JAX's unsharded runs here: paged and speculative
``generate``, ``chunked_prefill``, ``ChatModel``, the engine with a prefix
hit and with int8 weights. A counter on the shard arm shows that the
sharded kernels ran. ``ChatSession`` refuses a sharded pool (JAX's builds a
one-shard pool there, see ROADMAP's known faults).

Tolerances: greedy tokens, texts and engine stats exactly; chunk logits
2e-5 (tests/test_chunked_prefill.py's).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig, \
    debug_tiny
from v2pe_tpu.infer import paged_kv as jpk
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.chunked_prefill import chunked_prefill as jax_chunked
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.serve import engine as jengine
from v2pe_tpu_torch.infer import paged_kv as tpk
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.infer.session import ChatSession
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.ops import paged_attention as tpa
from v2pe_tpu_torch.parallel import context as pctx
from v2pe_tpu_torch.serve import engine as tengine

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config

QUESTIONS = ["Describe the picture.", "What color?", "Count the objects."]
IMG = 291


@contextlib.contextmanager
def shards(n):
    """``seq_shards=n`` on one card, counting the sharded arms' calls."""
    calls = {"decode": 0, "prefill": 0}
    dec, pre = (tpa.seq_sharded_paged_decode_attention,
                tpa.seq_sharded_chunked_prefill_attention)

    def count(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    tpa.seq_sharded_paged_decode_attention = count(dec, "decode")
    tpa.seq_sharded_chunked_prefill_attention = count(pre, "prefill")
    try:
        with pctx.use_sharding(pctx.ShardingContext(seq_shards=n)):
            yield calls
    finally:
        tpa.seq_sharded_paged_decode_attention = dec
        tpa.seq_sharded_chunked_prefill_attention = pre


def _sharpened(params):
    """wqkv sharpened: greedy tokens that depend on the cache."""
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    return {**params, "llm": {**params["llm"], "layers": layers}}


@pytest.fixture(scope="module")
def pair():
    """(JAX ChatModel, port ChatModel) over the same fp32 weights."""
    tok = _toy_tokenizer()
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=32,
                      intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        max_dynamic_patch=2)
    params = _sharpened(jax_init(jax.random.PRNGKey(0), cfg))
    pcfg = port_config(cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg)
    return (JaxChatModel(params, cfg, tok, attn_impl="jnp"),
            ChatModel(model, pcfg, tok, cache_mode="paged", page_size=4))


def _engine_kw(**kw):
    return dict(dict(max_rows=2, max_len=1024, page_size=8, chunk_size=64,
                     decode_block=4), **kw)


# --------------------------------------------------------------- generate


@pytest.fixture(scope="module")
def vlm():
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=300, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=4))
    params = _sharpened(jax_init(jax.random.PRNGKey(0), cfg))
    return cfg, params, from_jax_params(jax.tree.map(np.asarray, params),
                                        port_config(cfg))


@pytest.mark.parametrize("mode", ["plain", "int8_pool", "speculative"])
def test_generate_paged_under_shards_matches_jax(vlm, mode):
    """An image prompt (tests/test_decode_mesh.py:255) and a short text row
    through pages of 4 over 4 shards: tokens, steps and lengths as JAX's
    unsharded paged generate; speculation (K = 3) gives the greedy
    tokens."""
    cfg, params, model = vlm
    nit = cfg.num_image_token
    row0 = np.concatenate([np.arange(10, 22), [290], [IMG] * nit, [292],
                           np.arange(30, 39)])
    S = len(row0)
    ids = np.zeros((2, S), np.int32)
    ids[0] = row0
    ids[1, :9] = np.arange(60, 69)
    plen = np.array([S, 9], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (2, S)).copy()
    pixels = np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32)
    flags = np.array([1, 0], np.int32)
    gc = dict(max_new_tokens=9)
    kv = "int8" if mode == "int8_pool" else None
    jt, jn, jl = jax_generate(
        params, cfg, JaxGenerationConfig(**gc), jnp.asarray(ids),
        jnp.asarray(plen), jnp.asarray(pos), jnp.asarray(pixels),
        jnp.asarray(flags), IMG, attn_impl="jnp", cache_mode="paged",
        page_size=4, kv_dtype=kv)
    if mode == "speculative":
        gc["speculative_k"] = 3
    args = [torch.from_numpy(x) for x in (ids, plen, pos, pixels, flags)]
    with shards(4) as calls:
        tt, tn, tl = generate(model, port_config(cfg),
                              GenerationConfig(**gc), *args, IMG,
                              cache_mode="paged", page_size=4, kv_dtype=kv)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if mode != "speculative":
        assert tn == int(jn)
    # two layers a forward, every decode forward through the shard arm
    assert calls["decode"] >= 2 * (tn - 1 if mode != "speculative" else 1)


# ---------------------------------------------------------- chunked prefill


def test_chunked_prefill_under_shards_matches_jax():
    """Chunks of 25 and 35 tokens (tests/test_chunked_prefill.py:109) over
    a 4-shard pool: logits as JAX's unsharded chunked prefill; the pages
    placed round-robin over the shards."""
    cfg = debug_tiny(vocab_size=300)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_config(cfg))
    lc, tlc = cfg.llm, port_config(cfg).llm
    ids = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 60), 0,
                                      300))
    pos = np.arange(60, dtype=np.float32)[None]
    jc = jpk.PagedKVCache.zeros(lc, batch=1, n_pages=32, page_size=8,
                                max_pages_per_row=12, dtype=jnp.float32)
    tc = tpk.PagedKVCache.zeros(tlc, 1, 32, 8, 12, dtype=torch.float32,
                                n_shards=4)
    off = 0
    with shards(4) as calls:
        for S_c in (25, 35):
            sl = slice(off, off + S_c)
            jl, jc = jax_chunked(params["llm"], lc, jc,
                                 input_ids=jnp.asarray(ids[:, sl]),
                                 rope_pos_ids=jnp.asarray(pos[:, sl]),
                                 attn_impl="jnp")
            tl, tc = chunked_prefill(model.llm, tlc, tc,
                                     input_ids=torch.from_numpy(ids[:, sl]),
                                     rope_pos_ids=torch.from_numpy(pos[:, sl]))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                       rtol=2e-5)
            off += S_c
    assert calls["prefill"] == 2 * cfg.llm.num_hidden_layers
    pt = tc.page_table.numpy()[0]
    assert [p // 8 for p in pt[:8]] == [0, 1, 2, 3, 0, 1, 2, 3]


# ------------------------------------------------------------ chat, engine


def test_chat_under_shards_matches_jax(pair):
    """ChatModel.chat and batch_chat over the paged pool on 4 shards: the
    JAX model's texts."""
    jm, tm = pair
    gc = dict(max_new_tokens=6)
    refs = [jm.chat(None, q, JaxGenerationConfig(**gc)) for q in QUESTIONS]
    with shards(4) as calls:
        got = tm.batch_chat(None, QUESTIONS, GenerationConfig(**gc))
    assert got == refs
    assert calls["decode"] > 0


def test_engine_under_seq_shards_matches_jax(pair):
    """The engine built under seq 4 (tests/test_engine.py:251): a 4-shard
    allocator and pool, the unsharded JAX engine's texts and stats, a
    prefix-cache hit on the repeated question."""
    jm, tm = pair
    subs = QUESTIONS + [QUESTIONS[0]]
    jeng = jengine.InferenceEngine(jm, **_engine_kw())
    jreqs = [jeng.submit_chat(None, q, max_new_tokens=6) for q in subs]
    jeng.run_until_idle()
    with shards(4) as calls:
        teng = tengine.InferenceEngine(tm, **_engine_kw())
        assert teng.allocator.n_shards == 4 == teng.cache.n_shards
        treqs = [teng.submit_chat(None, q, max_new_tokens=6) for q in subs]
        teng.run_until_idle()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert [r.result(timeout=0) for r in treqs] == \
        [r.result(timeout=0) for r in jreqs]
    assert {k: teng.stats[k] for k in jeng.stats} == jeng.stats
    assert teng.stats["prefix_hit_pages"] > 0
    assert calls["decode"] > 0 and calls["prefill"] > 0
    total = teng.allocator.n_pages - teng.allocator.n_shards
    assert teng.allocator.available + teng.prefix_cache.evictable == total


def test_engine_thread_steps_under_its_own_context(pair):
    """An engine built under seq 4 and stepped on its own thread
    (``start``) while the main thread is under another context: every step
    sees the engine's context, the main thread sees its own throughout and
    after, and the texts are the unsharded JAX engine's."""
    jm, tm = pair
    jeng = jengine.InferenceEngine(jm, **_engine_kw())
    jreqs = [jeng.submit_chat(None, q, max_new_tokens=6)
             for q in QUESTIONS[:2]]
    jeng.run_until_idle()
    with shards(4):
        eng = tengine.InferenceEngine(tm, **_engine_kw())
    built, other = eng.ctx, pctx.ShardingContext(seq_shards=2)
    seen, step = [], eng._step
    eng._step = lambda: seen.append(pctx.current()) or step()
    main = []
    with pctx.use_sharding(other):
        eng.start()
        try:
            reqs = [eng.submit_chat(None, q, max_new_tokens=6)
                    for q in QUESTIONS[:2]]
            while not all(r.finished.wait(0.01) for r in reqs):
                main.append(pctx.current())
            texts = [r.result(timeout=60) for r in reqs]
        finally:
            eng.stop()
        assert pctx.current() is other
    assert pctx.current() is None
    assert built.seq_shards == 4 and seen and all(c is built for c in seen)
    assert main and all(c is other for c in main)
    assert texts == [r.result(timeout=0) for r in jreqs]


def test_engine_admits_what_fits_its_shards(pair):
    """JAX's admission check, ceil(need / n) pages on each shard: a request
    of more pages than one shard holds is admitted over 4 shards."""
    _, tm = pair
    with shards(4):
        eng = tengine.InferenceEngine(tm, **_engine_kw(pool_tokens=128,
                                                       max_len=256))
        per = eng.allocator.pages_per_shard - 1            # 4 usable
        ids = np.arange(4, 4 + 16 * per, dtype=np.int64)  # 9 pages
        req = eng.submit(ids, np.arange(len(ids), dtype=np.float32),
                         max_new_tokens=2)
        eng.run_until_idle()
        assert len(req.tokens) == 2
        with pytest.raises(ValueError):  # 26 pages: 7 on a shard of 4
            eng.submit(np.arange(4, 204), np.arange(200, dtype=np.float32),
                       max_new_tokens=8)


@pytest.mark.parametrize("n", [2, 4])
def test_int8_engine_under_shards_matches_jax(n):
    """int8 weights (kernels #7-#8's plain versions) under seq n: the JAX
    int8 engine's tokens (tests/test_quantized_weights.py:448)."""
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
    jm = JaxChatModel(params, cfg, tok, attn_impl="jnp",
                      weights_dtype="int8")
    tm = ChatModel(from_jax_params(jax.tree.map(np.asarray, params),
                                   port_config(cfg)), port_config(cfg), tok,
                   weights_dtype="int8")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(4, len(tok), size=s) for s in (19, 7)]
    kw = dict(max_rows=2, max_len=64, page_size=4, chunk_size=16,
              decode_block=4)

    def run(eng):
        reqs = [eng.submit(p, np.arange(len(p), dtype=np.float32),
                           max_new_tokens=4) for p in prompts]
        eng.run_until_idle()
        return [r.tokens for r in reqs]

    ref = run(jengine.InferenceEngine(
        jm, generation_config=JaxGenerationConfig(max_new_tokens=4,
                                                  eos_token_ids=(1,)), **kw))
    with shards(n):
        got = run(tengine.InferenceEngine(
            tm, generation_config=GenerationConfig(max_new_tokens=4,
                                                   eos_token_ids=(1,)), **kw))
    assert got == ref


def test_chat_session_refuses_shards(pair):
    """JAX's ChatSession sizes a one-shard pool whatever the context says,
    which a seq mesh then cannot split (ROADMAP, known faults): the port's
    raises under a sharded context and serves without one."""
    _, tm = pair
    with shards(2), pytest.raises(NotImplementedError):
        ChatSession(tm, max_len=512, page_size=8)
    assert isinstance(ChatSession(tm, max_len=512, page_size=8).send(
        None, QUESTIONS[0], GenerationConfig(max_new_tokens=2)), str)
