"""Serving across processes (gloo on the CPU): the paged pool split over the
mesh's ``seq`` axis, each rank holding NP/n pages, and over ``tensor``,
each rank holding its kv heads, the shards' partials meeting by two
all-reduces a layer; against unsharded JAX.

Two spawns of 4 ranks (``tests/torch_dist_worker.py``, task ``serve``):
``seq 2 x tensor 2`` (then ``fsdp 2 x tensor 2`` for dense generate, and
int8 / int4 weights sliced over ``tensor``) and ``seq 4``. Each rank runs
the paged path step by step (a prefill, a chunk over the history, a 5-token
verify step across a page boundary, single-token steps), paged and
speculative ``generate`` and the engine on two requests of different
lengths; the JAX references run in this process meanwhile. Every rank
must give the same tokens (the ranks agree on every host decision).

Tolerances: logits 2e-5 of JAX's teacher-forced forward
(tests/test_chunked_prefill.py's); tokens exactly, the quantized decoders'
too (against JAX's unsharded quantized model).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.models.internlm2 import llm_forward as jax_llm_forward
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.ops.quantized_matmul import \
    quantize_llm_params as jax_quantize_llm_params
from v2pe_tpu.serve import engine as jengine
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.ops.quantized_matmul import quantize_llm_params
from v2pe_tpu_torch.parallel import mesh as tmesh

from .test_data_pipeline import _toy_tokenizer
from .torch_dist import Run, np_tree
from .torch_parity import port_config

IMG = 5          # the image-context token id of the generate batch
WORLDS = {"seq2_tensor2": dict(seq=2, tensor=2), "seq4": dict(seq=4)}
CHECKS = ["layers", "paged", "speculative", "engine"]
QUANT = {"int8": dict(bits=8), "int4": dict(bits=4, group_size=16)}


def _cfg(vocab):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=8, num_key_value_heads=4),
        max_dynamic_patch=2)


def _gen_batch(cfg):
    """An image row and a shorter text row, right-padded."""
    nit = cfg.num_image_token
    row0 = np.concatenate([np.arange(10, 20), [IMG] * nit, np.arange(30, 36)])
    S = len(row0)
    ids = np.zeros((2, S), np.int32)
    ids[0] = row0
    ids[1, :9] = np.arange(40, 49)
    plen = np.array([S, 9], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (2, S)).copy()
    pixels = np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32)
    return ids, plen, pos, pixels, np.array([1, 0], np.int32)


def _jax_generate(params, cfg, gb, mode):
    """JAX's greedy tokens and lengths of the generate batch, 6 new."""
    toks, _, lens = jax_generate(
        params, cfg, JaxGenerationConfig(max_new_tokens=6), *gb, IMG,
        attn_impl="jnp", cache_mode=mode, page_size=4)
    return np.asarray(toks), np.asarray(lens)


def _jax_engine(params, cfg, tok, prompts):
    """JAX's engine on the two prompts, as the ranks run it."""
    eng = jengine.InferenceEngine(
        JaxChatModel(params, cfg, tok, attn_impl="jnp"), max_rows=2,
        max_len=64, page_size=4, chunk_size=16, decode_block=4,
        generation_config=JaxGenerationConfig(max_new_tokens=6,
                                              eos_token_ids=(1,)))
    reqs = [eng.submit(p, np.arange(len(p), dtype=np.float32),
                       max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both spawns started, then JAX's unsharded references (the fp32
    weights, and the same quantized to int8 and int4) computed here while
    they run."""
    tok = _toy_tokenizer()
    tokdir = tmp_path_factory.mktemp("serve_tok")
    tok.save_pretrained(str(tokdir))
    cfg = _cfg(len(tok))
    params = jax_init(jax.random.PRNGKey(0), cfg)
    layers = dict(params["llm"]["layers"])  # scores far from uniform
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    rng = np.random.RandomState(3)
    spec = dict(cfg=port_config(cfg).to_json(), tree=np_tree(params),
                tokenizer=str(tokdir), img_context_id=IMG,
                ids=rng.randint(6, len(tok), (2, 46)).astype(np.int64),
                gen_batch=_gen_batch(cfg),
                prompts=[rng.randint(6, len(tok), size=s) for s in (19, 7)])
    serve = lambda mesh, checks, **kw: dict(  # noqa: E731
        kind="serve", mesh=mesh, checks=checks, **kw)
    runs = {
        "seq2_tensor2": Run(dict(spec, tasks=[
            serve(WORLDS["seq2_tensor2"], CHECKS),
            serve(dict(fsdp=2, tensor=2), ["dense"]),
            *(serve(dict(seq=2, tensor=2), ["paged", "engine"], **q)
              for q in QUANT.values())]), 4,
            tmp_path_factory.mktemp("serve_seq2_tensor2")),
        "seq4": Run(dict(spec, tasks=[serve(WORLDS["seq4"], CHECKS)]), 4,
                    tmp_path_factory.mktemp("serve_seq4"))}

    ref = {}
    logits, _ = jax_llm_forward(
        params["llm"], cfg.llm, input_ids=jnp.asarray(spec["ids"]),
        rope_pos_ids=jnp.broadcast_to(jnp.arange(46, dtype=jnp.float32),
                                      (2, 46)), attn_impl="jnp")
    ref["layers"] = np.asarray(logits)
    gb = [jnp.asarray(x) for x in spec["gen_batch"]]
    for mode in ("paged", "dense"):
        ref[mode] = _jax_generate(params, cfg, gb, mode)
    ref["engine"] = _jax_engine(params, cfg, tok, spec["prompts"])
    # the quantized decoders, unsharded, in JAX (its dequantized products)
    for name, q in QUANT.items():
        qparams = {**params, "llm": jax_quantize_llm_params(
            params["llm"], q["bits"], q.get("group_size", 128))}
        ref[name] = {"paged": _jax_generate(qparams, cfg, gb, "paged"),
                     "engine": _jax_engine(qparams, cfg, tok,
                                           spec["prompts"])}
    return cfg, {k: r.result() for k, r in runs.items()}, ref


def _ranks(out, task, check):
    """Every rank's result of a check, asserted equal across the ranks
    where it is tokens."""
    return [r[check] for r in out[task]]


@pytest.mark.parametrize("world", list(WORLDS))
def test_paged_layers_match_jax(served, world):
    """Prefill, a chunk over the history, a 5-token verify step across a
    page boundary and 3 single-token steps on each rank's shard of the
    pool: the logits of JAX's unsharded forward, on every rank; the pool
    holds NP/n pages and Hkv/nt heads."""
    cfg, out, ref = served
    at = np.cumsum([0, 20, 18, 5, 1, 1, 1])
    n_seq = WORLDS[world]["seq"]
    nt = WORLDS[world].get("tensor", 1)
    for r in _ranks(out[world], 0, "layers"):
        for i, lg in enumerate(r["logits"]):
            np.testing.assert_allclose(lg, ref["layers"][:, at[i]:at[i + 1]],
                                       atol=2e-5, rtol=2e-5)
        assert r["shards"] == n_seq
        L, heads, pages = r["pool"][:3]
        assert heads == cfg.llm.num_key_value_heads // nt
        assert pages == 2 * -(-8 // n_seq) + 1   # this rank's shard


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("check", ["paged", "speculative"])
def test_generate_matches_jax(served, world, check):
    """Paged generate, and with prompt-lookup speculation (K = 3): JAX's
    unsharded greedy tokens on every rank."""
    _, out, ref = served
    for toks, lens in _ranks(out[world], 0, check):
        np.testing.assert_array_equal(toks, ref["paged"][0])
        np.testing.assert_array_equal(lens, ref["paged"][1])


@pytest.mark.parametrize("world", list(WORLDS))
def test_engine_matches_jax(served, world):
    """The engine on two requests of different lengths: every rank emits
    JAX's tokens, with the same stats, over a pool of NP/n pages a rank."""
    _, out, ref = served
    ranks = _ranks(out[world], 0, "engine")
    for r in ranks:
        assert r["tokens"] == ref["engine"]
        assert r["stats"] == ranks[0]["stats"]
        assert r["shards"] == WORLDS[world]["seq"]


def test_dense_generate_fsdp_tensor_matches_jax(served):
    """Dense generate with weights over fsdp 2 x tensor 2
    (tests/test_decode_mesh.py:60): the layers gather through FSDP2's hooks,
    the rest once; JAX's tokens on every rank."""
    _, out, ref = served
    for toks, lens in _ranks(out["seq2_tensor2"], 1, "dense"):
        np.testing.assert_array_equal(toks, ref["dense"][0])
        np.testing.assert_array_equal(lens, ref["dense"][1])


@pytest.mark.parametrize("name", list(QUANT))
def test_quantized_decoder_on_tensor_slices(served, name):
    """int8 and int4 decoders placed by shard_model under seq 2 x tensor 2
    (#7-#10's plain versions on the slices): JAX's unsharded quantized
    model's paged tokens and engine tokens on every rank (JAX's products
    dequantize, the same maths); the ranks agree besides."""
    _, out, ref = served
    task = 2 + list(QUANT).index(name)
    for toks, lens in _ranks(out["seq2_tensor2"], task, "paged"):
        np.testing.assert_array_equal(toks, ref[name]["paged"][0])
        np.testing.assert_array_equal(lens, ref[name]["paged"][1])
    engines = _ranks(out["seq2_tensor2"], task, "engine")
    for e in engines:
        assert e["tokens"] == ref[name]["engine"]
        assert e["stats"] == engines[0]["stats"]


def test_quantized_units_follow_the_group_rule():
    """A quantized unit splits where the axis divides its width and, for
    int4, a rank's rows hold whole scale groups in both halves; else it
    stays whole (``_fit_spec``), as the bf16 weights' units do."""
    cfg = port_config(_cfg(300))
    model = from_jax_params(np_tree(jax_init(jax.random.PRNGKey(0),
                                             _cfg(300))), cfg)
    for bits, gs, want in ((8, 128, ["llm_attn", "llm_mlp"]),
                           (4, 16, ["llm_attn", "llm_mlp"]),
                           (4, 128, [])):
        llm = quantize_llm_params(model.llm, bits, gs)
        assert tmesh.quantized_tensor_units(llm, cfg, 2) == want
        assert tmesh.quantized_tensor_units(llm, cfg, 1) == []
    # int8 wo rows over 2 ranks, and int4 repacked: the slices' products
    # sum to the whole product
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    for bits, gs in ((8, 128), (4, 16)):
        whole = quantize_llm_params(model.llm, bits, gs).stacks["wo"]
        parts = [tmesh._quant_slice(whole, "row", 2, i) for i in range(2)]
        from v2pe_tpu_torch.ops.quantized_matmul import \
            quantized_dot_stacked
        full = quantized_dot_stacked(x, whole, 1)
        split = sum(quantized_dot_stacked(x[:, i * 32:(i + 1) * 32], p, 1)
                    for i, p in enumerate(parts))
        np.testing.assert_allclose(split.numpy(), full.numpy(), atol=2e-5,
                                   rtol=2e-5)
