"""The two other decoder families of the published InternVL2 checkpoints
through the port's serving and training paths, against the JAX package on
the CPU in fp32: Phi-3's head dim 96 (InternVL2-4B: 32 / 32 heads of 96)
and Qwen2's group of seven (InternVL2-1B: 14 / 2 heads of 64, q/k/v bias),
each as a tiny decoder (``phi3``: 2 / 2 heads of 96; ``qwen2``: 7 / 1
heads of 64 with a random q/k/v bias) of 2 layers behind a 2-layer ViT.
The packed forward, dense and paged greedy ``generate`` (a pool in the
model's dtype, an int8 and an int4 pool), int8 and int4 weights, speculative
``generate`` with K = 4 (5-token verify forwards: at G = 7, 35 query rows
a kv head, the decode kernel's three row blocks on the card), a 2-row
``InferenceEngine`` and one ``make_train_step`` step.

Tolerances: those of the tests these mirror. Packed logits 2e-5
(``tests/test_torch_models.py``); greedy tokens, lengths, verify counts,
engine texts and stats identical (``tests/test_torch_gqa4.py``), on a model
whose wqkv is sharpened (SHARPEN) so that the tokens depend on the cache;
the train step's loss within 1e-5, grad norm 1e-4 and parameters 1e-5
(``tests/test_torch_train.py``).
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
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models import internvl_chat as tchat
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params
from v2pe_tpu_torch.ops import paged_attention as tpa
from v2pe_tpu_torch.serve import engine as tengine
from v2pe_tpu_torch.train import optimizer as topt
from v2pe_tpu_torch.train import train_step as tstep

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import one_thread, port_config, run_parity  # noqa: F401

TOK = _toy_tokenizer()
IMG = TOK.convert_tokens_to_ids("<IMG_CONTEXT>")
START, END = 3, 4  # the image's bracketing tokens in the made-up prompts
FAMILIES = {
    "phi3": dict(arch="phi3", hidden_size=192, num_attention_heads=2,
                 num_key_value_heads=2),
    "qwen2": dict(arch="qwen2", hidden_size=448, num_attention_heads=7,
                  num_key_value_heads=1, qkv_bias=True),
}
# wqkv is multiplied by this: test_torch_gqa4.py's x30 at its widths (hidden
# 128, head dim 16) puts the scores, which grow as sqrt(head dim) x hidden
# x the factor squared, where x15.7 (phi3) and x11.3 (qwen2) put them here;
# a little under that, so that the fp32 sums of the two packages, in their
# own orders, stay inside the packed logits' 2e-5
SHARPEN = {"phi3": 12.0, "qwen2": 7.0}


def _cfg(family: str):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(TOK), intermediate_size=64,
                      num_hidden_layers=2, **FAMILIES[family]),
        rope_pos_id_stride=2, max_dynamic_patch=2)


@pytest.fixture(scope="module", params=list(FAMILIES))
def models(request):
    """JAX params (wqkv sharpened, Qwen2's q/k/v bias random) and the
    port's model from them."""
    cfg = _cfg(request.param)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * SHARPEN[request.param]
    if cfg.llm.qkv_bias:
        layers["wqkv_bias"] = jnp.asarray(np.random.default_rng(1).normal(
            0.0, 0.2, layers["wqkv_bias"].shape).astype(np.float32))
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_config(cfg))
    head_dim = cfg.llm.hidden_size // cfg.llm.num_attention_heads
    assert (head_dim, cfg.llm.num_attention_heads
            // cfg.llm.num_key_value_heads) in ((96, 1), (64, 7))
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


def test_decode_plan_at_g7():
    """Qwen2's group: one fresh token gives 7 query rows a kv head, one
    block of 8 (the store-then-attend launch takes it); a 5-token verify
    35 rows, three blocks of 16."""
    one = tpa.decode_plan(1, 2, 257, 128, 1, 7)
    assert (one.rows, one.row_blocks) == (8, 1)
    verify = tpa.decode_plan(1, 2, 257, 128, 5, 7)
    assert (verify.rows, verify.row_blocks) == (16, 3)


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


@pytest.mark.parametrize("cache", ["dense", "paged", "paged_int8",
                                   "paged_int4"])
def test_generate_matches_jax(models, cache):
    """A ragged batch (an image row and a text row), greedy over the dense
    cache and over pages of 4 (in the model's dtype, int8, int4): tokens,
    steps and lengths identical to JAX's."""
    cfg, params, model = models
    kw = {} if cache == "dense" else dict(
        cache_mode="paged", page_size=4,
        kv_dtype=cache.split("_")[1] if "_" in cache else None)
    _same_tokens(*_both_generate(cfg, params, model,
                                 dict(max_new_tokens=7, eos_token_ids=(7,)),
                                 **kw))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_generate_matches_jax(models, bits):
    """The same batch through int8 and int4 weights (``QuantizedInternLM2``,
    the JAX quantizer's codes and scales) over a pool of the same width,
    pages of 4."""
    cfg, params, _ = models
    qparams = {**params, "llm": jq.quantize_llm_params(params["llm"],
                                                       bits=bits)}
    qmodel = from_jax_params(jax.tree.map(np.asarray, qparams),
                             port_config(cfg))
    assert isinstance(qmodel.llm, internlm2.QuantizedInternLM2)
    _same_tokens(*_both_generate(cfg, qparams, qmodel,
                                 dict(max_new_tokens=6, eos_token_ids=(7,)),
                                 cache_mode="paged", page_size=4,
                                 kv_dtype=f"int{bits}"))


def test_speculative_generate_at_t5_matches_plain_and_jax(models):
    """speculative_k = 4 over pages of 4 on a prompt that drafts hit:
    the plain greedy tokens, and JAX's speculative tokens, lengths and
    verify count."""
    cfg, params, model = models
    base = dict(max_new_tokens=8, eos_token_ids=(7,))
    paged = dict(cache_mode="paged", page_size=4)
    ids, plen, pos, pixels, flags = _batch(cfg, repeat=True)
    plain = generate(model, port_config(cfg), GenerationConfig(**base),
                     *map(torch.from_numpy, (ids, plen, pos, pixels, flags)),
                     IMG, **paged)
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
    gc = GenerationConfig(max_new_tokens=5)
    refs = [tc.chat(pv, questions[0], gc), tc.chat(None, questions[1], gc),
            tc.chat(None, questions[2], gc)]
    kw = dict(max_rows=2, max_len=512, page_size=8, chunk_size=32,
              decode_block=4)
    reqs = []
    for eng in (jengine.InferenceEngine(jc, **kw),
                tengine.InferenceEngine(tc, **kw)):
        reqs.append([eng.submit_chat(pv, q, max_new_tokens=5)
                     if i == 0 else eng.submit_chat(None, q,
                                                    max_new_tokens=5)
                     for i, q in enumerate(questions)])
        eng.run_until_idle()
        reqs[-1].append(eng.stats)
    (*jreqs, jstats), (*treqs, tstats) = reqs
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        assert tr.result(timeout=0) == jr.result(timeout=0)
    assert [r.result(timeout=0) for r in treqs] == refs
    assert {k: tstats[k] for k in jstats} == jstats


def _unsharpened(cfg, params):
    """``params`` with wqkv as drawn: a sharpened softmax leaves gradient
    elements near 0, where Adam's normalised update differs by a share of
    the learning rate between two sums in other orders."""
    family = cfg.llm.arch
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] / SHARPEN[family]
    return {**params, "llm": {**params["llm"], "layers": layers}}


def test_train_step_matches_jax(models):
    """One make_train_step step (remat 'full', AdamW at the card's train
    recipe's lr 1e-5, here without the warmup step, whose rate is 0) on a
    packed batch of two rows, one image tile each, from the fixture's
    weights with wqkv unsharpened (_unsharpened): loss, grad norm and the
    updated parameters against JAX's step."""
    cfg, params, _ = models
    params = _unsharpened(cfg, params)
    nit = cfg.num_image_token
    rng = np.random.default_rng(3)
    B, S = 2, 64
    ids = rng.integers(10, 70, (B, S)).astype(np.int32)
    rope = np.broadcast_to(np.arange(S, dtype=np.float32), (B, S)).copy()
    gather = np.full((B, S), -1, np.int32)
    for b in range(B):
        at = 5 + 3 * b
        ids[b, at - 1], ids[b, at:at + nit], ids[b, at + nit] = \
            START, IMG, END
        rope[b, at:at + nit] = at - 1 + 0.5 * np.arange(1, nit + 1)
        rope[b, at + nit:] = rope[b, at + nit - 1] + np.arange(
            1, S - at - nit + 1)
        gather[b, at:at + nit] = np.arange(nit) + b * nit
    seg = np.ones((B, S), np.int32)
    seg[1, 50:] = 0
    targets = np.full((B, S), -100, np.int32)
    targets[:, :-1] = ids[:, 1:]
    targets[ids == IMG] = -100
    targets[seg == 0] = -100
    batch = dict(
        input_ids=ids, rope_pos_ids=rope, segment_ids=seg, targets=targets,
        loss_weight=(targets != -100).astype(np.float32),
        token_positions=np.broadcast_to(np.arange(S, dtype=np.int32),
                                        (B, S)).copy(),
        vit_gather_idx=gather,
        pixel_values=rng.standard_normal((B, 3, 56, 56)).astype(np.float32),
        image_flags=np.ones(B, np.int32))
    tc_kw = dict(learning_rate=1e-5, warmup_steps=0, total_steps=100)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_config(cfg))
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), params)
    jfn = jstep.make_train_step(cfg, tx, None, IMG, attn_impl="jnp",
                                remat="full", donate=False)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), model,
                               port_config(cfg))
    tfn = tstep.make_train_step(port_config(cfg), opt,
                                img_context_token_id=IMG, remat="full")
    new, _, m = jfn(params, tx.init(params),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    loss, gnorm = tfn(model, opt.init(), {k: torch.from_numpy(np.array(v))
                                          for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), float(m["grad_norm"]),
                               rtol=1e-4)
    want = _jax_state_dict(jax.tree.map(np.asarray, new), port_config(cfg))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)
