"""A decoder with four query heads a kv head (G = 4, InternVL2.5-8B's
group: 32 / 8 heads) through the port's serving paths, against the JAX
package on the CPU in fp32: the packed forward, dense and paged greedy
``generate``, an int8 pool, int8 weights, speculative ``generate`` with
K = 4 (5-token verify forwards: T x G = 20 query rows a kv head, the
decode kernel's two row blocks on the card) and a 2-row
``InferenceEngine``. The other serving tests run G = 2.

Tolerances: those of the G = 2 tests these mirror. Packed logits 2e-5
(``tests/test_torch_models.py``); greedy tokens, lengths, verify counts,
engine texts and stats identical (``tests/test_torch_paged.py``,
``tests/test_torch_quantized.py``, ``tests/test_torch_speculative.py``,
``tests/test_torch_engine.py``), on a model whose wqkv is sharpened so
that the tokens depend on the cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.models import internvl_chat as jchat
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.ops import quantized_matmul as jq
from v2pe_tpu.serve import engine as jengine
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models import internvl_chat as tchat
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.ops import paged_attention as tpa
from v2pe_tpu_torch.serve import engine as tengine

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import one_thread, port_config, run_parity  # noqa: F401

HQ, HKV = 8, 2
TOK = _toy_tokenizer()
IMG = TOK.convert_tokens_to_ids("<IMG_CONTEXT>")
START, END = 3, 4  # the image's bracketing tokens in the made-up prompts


def _cfg():
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(TOK), hidden_size=128,
                      intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=HQ, num_key_value_heads=HKV),
        rope_pos_id_stride=2, max_dynamic_patch=2)


@pytest.fixture(scope="module")
def models():
    """JAX params (wqkv sharpened) and the port's model from them."""
    cfg = _cfg()
    params = jax_init(jax.random.PRNGKey(0), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_config(cfg))
    assert cfg.llm.num_attention_heads // cfg.llm.num_key_value_heads == 4
    return cfg, params, model


def _batch(cfg, repeat: bool = False):
    """Two right-padded prompts: row 0 holds one image tile at fractional
    V2PE positions (and, with ``repeat``, a repeated span that drafts can
    copy from), row 1 is shorter text."""
    nit = cfg.num_image_token
    tail = np.tile(np.arange(30, 35), 3) if repeat else np.arange(30, 35)
    row0 = np.concatenate([np.arange(10, 20), [START], [IMG] * nit, [END],
                           tail])
    S = len(row0)
    ids = np.zeros((2, S), np.int32)
    ids[0] = row0
    ids[1, :12] = np.arange(40, 52)
    plen = np.array([S, 12], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (2, S)).copy()
    pos[0, 11:11 + nit] = 10 + 0.5 * np.arange(1, nit + 1)
    pos[0, 11 + nit:] = pos[0, 10 + nit] + np.arange(1, S - 10 - nit)
    pixels = np.random.default_rng(0).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    return ids, plen, pos, pixels, np.array([1, 0], np.int32)


def _both_generate(cfg, params, model, gc, repeat=False, **kw):
    """JAX's and the port's generate on the same batch: (tokens, steps,
    lengths) of each."""
    ids, plen, pos, pixels, flags = _batch(cfg, repeat)
    j = jax_generate(params, cfg, JaxGenerationConfig(**gc),
                     jnp.asarray(ids), jnp.asarray(plen), jnp.asarray(pos),
                     jnp.asarray(pixels), jnp.asarray(flags), IMG,
                     attn_impl="jnp", **kw)
    t = generate(model, port_config(cfg), GenerationConfig(**gc),
                 torch.from_numpy(ids), torch.from_numpy(plen),
                 torch.from_numpy(pos), torch.from_numpy(pixels),
                 torch.from_numpy(flags), IMG, **kw)
    return j, t


def _same_tokens(j, t):
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    assert t[1] == int(j[1])


def test_decode_plan_at_g4():
    """One fresh token: 4 query rows a kv head, one row block (the
    store-then-attend launch takes it); a 5-token verify: 20 rows, two
    blocks of 16."""
    one = tpa.decode_plan(4, 8, 64, 512, 1, 4)
    assert (one.rows, one.row_blocks) == (4, 1)
    verify = tpa.decode_plan(4, 8, 64, 512, 5, 4)
    assert (verify.rows, verify.row_blocks) == (16, 2)


def test_packed_forward_matches_jax(models):
    """Two segments, one with two image tiles, through the whole model:
    logits within 2e-5 of JAX's."""
    cfg, params, model = models
    nit = cfg.num_image_token
    ids = np.concatenate([np.arange(10, 20), [START], [IMG] * (2 * nit),
                          [END], np.arange(30, 45)]).astype(np.int32)[None]
    S = ids.shape[1]
    rope = np.arange(S, dtype=np.float32)[None]
    rope[0, 11:11 + 2 * nit] = 10 + 0.5 * np.arange(1, 2 * nit + 1)
    rope[0, 11 + 2 * nit:] = rope[0, 10 + 2 * nit] + np.arange(
        1, S - 10 - 2 * nit)
    seg = np.ones((1, S), np.int32)
    seg[0, -5:] = 2
    pos = np.arange(S, dtype=np.int32)[None]
    pixels = np.random.default_rng(1).standard_normal(
        (2, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        p = run_parity(
            lambda i, px, f, r, s, t: jchat.forward(
                params, cfg, input_ids=i, pixel_values=px, image_flags=f,
                rope_pos_ids=r, img_context_token_id=IMG, segment_ids=s,
                token_positions=t, attn_impl="jnp").logits,
            lambda i, px, f, r, s, t: tchat.forward(
                model, port_config(cfg), input_ids=i.long(),
                pixel_values=px, image_flags=f, rope_pos_ids=r,
                img_context_token_id=IMG, segment_ids=s,
                token_positions=t).logits,
            ids, pixels, np.ones(2, np.int32), rope, seg, pos)
    p.assert_close(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("cache", ["dense", "paged", "paged_int8"])
def test_generate_matches_jax(models, cache):
    """A ragged batch (an image row and a text row), greedy over the dense
    cache, pages of 4, and pages of 4 over an int8 pool: tokens, steps and
    lengths identical to JAX's."""
    cfg, params, model = models
    kw = {} if cache == "dense" else dict(
        cache_mode="paged", page_size=4,
        kv_dtype="int8" if cache == "paged_int8" else None)
    _same_tokens(*_both_generate(cfg, params, model,
                                 dict(max_new_tokens=9, eos_token_ids=(7,)),
                                 **kw))


def test_int8_weights_over_an_int8_pool_generate_matches_jax(models):
    """The same batch through int8 weights (``QuantizedInternLM2``, the
    JAX quantizer's codes and scales) over an int8 pool of pages of 4."""
    cfg, params, _ = models
    qparams = {**params, "llm": jq.quantize_llm_params(params["llm"],
                                                       bits=8)}
    qmodel = from_jax_params(jax.tree.map(np.asarray, qparams),
                             port_config(cfg))
    assert isinstance(qmodel.llm, internlm2.QuantizedInternLM2)
    _same_tokens(*_both_generate(cfg, qparams, qmodel,
                                 dict(max_new_tokens=7, eos_token_ids=(7,)),
                                 cache_mode="paged", page_size=4,
                                 kv_dtype="int8"))


def test_speculative_generate_at_t5_matches_plain_and_jax(models):
    """speculative_k = 4 over pages of 4 on a prompt that drafts hit:
    the plain greedy tokens, and JAX's speculative tokens, lengths and
    verify count."""
    cfg, params, model = models
    base = dict(max_new_tokens=9, eos_token_ids=(7,))
    paged = dict(cache_mode="paged", page_size=4)
    _, plain = _both_generate(cfg, params, model, base, repeat=True,
                              **paged)
    j, t = _both_generate(cfg, params, model,
                          dict(base, speculative_k=4, speculative_ngram=2),
                          repeat=True, **paged)
    _same_tokens(j, t)
    np.testing.assert_array_equal(t[0].numpy(), plain[0].numpy())
    np.testing.assert_array_equal(t[2].numpy(), plain[2].numpy())
    assert t[1] <= int(plain[2].max())


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), np.uint8))


def test_engine_matches_isolated_chat_and_jax(models):
    """Three requests (one with an image) through 2-row engines: the third
    queues until a row frees; the port's texts equal its own isolated
    ``chat`` and the JAX engine's, token for token, with equal stats."""
    cfg, params, model = models
    jc = JaxChatModel(params, cfg, TOK, attn_impl="jnp")
    tc = ChatModel(model, port_config(cfg), TOK)
    pv, _ = tc.load_pixels(_image(0, 64, 80))
    questions = ["Describe the picture.", "What color?", "Count them."]
    gc = GenerationConfig(max_new_tokens=6)
    refs = [tc.chat(pv, questions[0], gc), tc.chat(None, questions[1], gc),
            tc.chat(None, questions[2], gc)]
    kw = dict(max_rows=2, max_len=512, page_size=8, chunk_size=32,
              decode_block=4)
    reqs = []
    for eng in (jengine.InferenceEngine(jc, **kw),
                tengine.InferenceEngine(tc, **kw)):
        reqs.append([eng.submit_chat(pv, questions[0], max_new_tokens=6),
                     eng.submit_chat(None, questions[1], max_new_tokens=6),
                     eng.submit_chat(None, questions[2], max_new_tokens=6)])
        eng.run_until_idle()
        reqs[-1].append(eng.stats)
    (*jreqs, jstats), (*treqs, tstats) = reqs
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        assert tr.result(timeout=0) == jr.result(timeout=0)
    assert [r.result(timeout=0) for r in treqs] == refs
    assert {k: tstats[k] for k in jstats} == jstats
