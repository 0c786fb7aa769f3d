"""Weight-only int8 / int4 serving of the PyTorch port against the JAX package
on the CPU. The same numpy weights and inputs go through both: the
quantizers, the plain versions of the four quantized products against the
four Pallas kernels in interpret mode and against the jnp dequant arm,
``from_jax_params`` on a JAX quantized tree, ``llm_forward``, ``generate``
over the dense and the paged cache, ``ChatModel(weights_dtype=...)``,
``ChatSession`` and the HTTP worker.

Tolerances. The quantizers: codes and scales equal bit for bit (the port
divides as JAX's eager quantize does). One product: both sides multiply the
same bf16-exact operands and differ only in the order of the fp32 sum, so
outputs agree within ``DOT_TOL`` of the output's range. A model: x is
rounded to bf16 before every product, so a sum that differs in its last bit
can land on the other side of a bf16 step one layer later (a relative step
of 2^-8 on one element of x); fp32 logits of the 2-layer models agree
within ``LOGIT_TOL`` of the logits' range. Greedy tokens are compared
exactly on inputs (fixed seeds) whose every step has a top-2 logit margin
above that tolerance; the dense generate test checks the margins.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.infer.session import ChatSession as JaxChatSession
from v2pe_tpu.models.internlm2 import llm_forward as jax_llm_forward
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.ops import quantized_matmul as jq
from v2pe_tpu.serve.worker import ModelWorker as JaxModelWorker
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.infer.session import ChatSession
from v2pe_tpu_torch.infer.streaming import stream_generate
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.params import from_jax_params, jax_leaf_map
from v2pe_tpu_torch.ops import quantized_matmul as tq
from v2pe_tpu_torch.serve.worker import ModelWorker

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config

DOT_TOL = 2e-6    # max |port - jax| / max |jax| of one product
LOGIT_TOL = 2e-3  # the same of a model's fp32 logits
IMG = 291
BITS = {"int8": 8, "int4": 4}


# ------------------------------------------------------------- quantizers


def _weights(shape, seed):
    """Normal weights; the last output channel is all zero (scale 1)."""
    w = (np.random.default_rng(seed).standard_normal(shape) * 0.05
         ).astype(np.float32)
    if shape[-1] > 1:
        w[..., -1] = 0.0
    return w


# (D, N): D/2 = 128 keeps group 128; 96 and 40 shrink it to gcd(128, D/2);
# 300, 130 and 1 pad N to the next multiple of 128
SHAPES = [(256, 300), (96, 128), (40, 130), (64, 1)]


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("D,N", SHAPES)
def test_quantize_weight_matches_jax(D, N, lead):
    w = _weights((*lead, D, N), D + N)
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(w))
    assert got.n_out == want.n_out == N
    assert got.q.shape[-1] % 128 == 0 and got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.q.numpy()[..., N:] == 0).all()
    assert (got.scale.numpy()[..., N:] == 1).all()


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("D,N", SHAPES)
def test_quantize_weight_int4_matches_jax(D, N, lead):
    w = _weights((*lead, D, N), D + N + 1)
    want = jq.quantize_weight_int4(jnp.asarray(w))
    got = tq.quantize_weight_int4(torch.from_numpy(w))
    assert (got.n_out, got.group_size) == (want.n_out, want.group_size)
    assert got.group_size == np.gcd(128, D // 2)
    np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    lo, hi = tq.unpack_nibbles(got.p)
    jlo, jhi = jq._unpack_nibbles(want.p)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert int(lo.abs().max()) <= 7 and int(hi.abs().max()) <= 7


def test_int4_needs_an_even_depth():
    with pytest.raises(ValueError):
        tq.quantize_weight_int4(torch.zeros(7, 8))


# ----------------------------------------------- the products, one by one


def _close(got, want, tol=DOT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _x(M, D, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((M, D)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M", [1, 3, 21])
@pytest.mark.parametrize("D,N", SHAPES[:3])
def test_int8_products_match_pallas_and_jnp(D, N, M, xdtype):
    """quantized_dot_torch against _qdot_2d, quantized_dot_stacked_torch
    against _qdot_2d_stacked (interpret mode), both against the jnp arm."""
    w = _weights((3, D, N), 7 * D + N)
    jw = jq.quantize_weight(jnp.asarray(w))
    tw = tq.QuantizedWeight(torch.from_numpy(np.array(jw.q)),
                            torch.from_numpy(np.array(jw.scale)), N)
    jx, tx = _x(M, D, M, xdtype)
    for li in (0, 2):
        got = tq.quantized_dot_stacked_torch(tx, tw, li, torch.float32)
        _close(got, jq._qdot_2d_stacked(jx, jw.q, jw.scale, jnp.int32(li), N,
                                        True))
        one = tq.QuantizedWeight(tw.q[li].clone(), tw.scale[li].clone(), N)
        flat = tq.quantized_dot_torch(tx, one, torch.float32)
        _close(flat, jq._qdot_2d(jx, jw.q[li], jw.scale[li], N, True))
        assert torch.equal(flat, got)
        arm = jnp.dot(jx.astype(jnp.bfloat16), jw.q[li].astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32) * jw.scale[li]
        _close(got, arm[:, :N])
    # the wrapper on a CPU tensor is the plain version; out_dtype defaults
    # to x's
    out = tq.quantized_dot_stacked(tx, tw, 1)
    assert out.dtype == tx.dtype and out.shape == (M, N)
    assert torch.equal(out, tq.quantized_dot_stacked_torch(tx, tw, 1))


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M", [1, 3, 21])
@pytest.mark.parametrize("D,N", SHAPES[:3])
def test_int4_products_match_pallas_and_jnp(D, N, M, xdtype):
    """The same for _q4dot_2d and _q4dot_2d_stacked and the jnp dequant
    arm (_dequant_int4_jnp, one full-depth dot)."""
    w = _weights((3, D, N), 5 * D + N)
    jw = jq.quantize_weight_int4(jnp.asarray(w))
    gs = jw.group_size
    tw = tq.Int4Weight(torch.from_numpy(np.array(jw.p)),
                       torch.from_numpy(np.array(jw.scale)), N, gs)
    jx, tx = _x(M, D, M + 1, xdtype)
    for li in (0, 2):
        got = tq.quantized_dot_stacked_torch(tx, tw, li, torch.float32)
        _close(got, jq._q4dot_2d_stacked(jx, jw.p, jw.scale, jnp.int32(li), N,
                                         gs, True))
        one = tq.Int4Weight(tw.p[li].clone(), tw.scale[li].clone(), N, gs)
        flat = tq.quantized_dot_torch(tx, one, torch.float32)
        _close(flat, jq._q4dot_2d(jx, jw.p[li], jw.scale[li], N, gs, True))
        assert torch.equal(flat, got)
        deq = jq._dequant_int4_jnp(jq.Int4Weight(jw.p[li], jw.scale[li], N,
                                                 gs))
        arm = jnp.dot(jx.astype(jnp.bfloat16), deq,
                      preferred_element_type=jnp.float32)
        _close(got, arm[:, :N])
    out = tq.quantized_dot(tx[None], one)
    assert out.dtype == tx.dtype and out.shape == (1, M, N)


# M on both sides of the kernels' body switch (16 / 17) and of the wgmma
# body's 64-row warpgroup tiles; (40, 130) has gs 4, below the strip's
# 16-row split granule
EDGE_M = [16, 17, 64, 65]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", EDGE_M)
@pytest.mark.parametrize("D,N", [SHAPES[0], SHAPES[2]])
def test_products_match_pallas_and_jnp_at_the_body_edges(D, N, M, bits):
    """The stacked plain versions against the Pallas kernels (interpret
    mode) and the jnp arms at the M where the CUDA kernels change body,
    bf16 x, fp32 out."""
    w = _weights((2, D, N), 11 * D + N + bits)
    jx, tx = _x(M, D, 3 * M + bits, jnp.bfloat16)
    if bits == 8:
        jw = jq.quantize_weight(jnp.asarray(w))
        tw = tq.QuantizedWeight(torch.from_numpy(np.array(jw.q)),
                                torch.from_numpy(np.array(jw.scale)), N)
        want = jq._qdot_2d_stacked(jx, jw.q, jw.scale, jnp.int32(1), N, True)
        arm = jnp.dot(jx, jw.q[1].astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32) * jw.scale[1]
    else:
        jw = jq.quantize_weight_int4(jnp.asarray(w))
        gs = jw.group_size
        tw = tq.Int4Weight(torch.from_numpy(np.array(jw.p)),
                           torch.from_numpy(np.array(jw.scale)), N, gs)
        want = jq._q4dot_2d_stacked(jx, jw.p, jw.scale, jnp.int32(1), N, gs,
                                    True)
        deq = jq._dequant_int4_jnp(jq.Int4Weight(jw.p[1], jw.scale[1], N, gs))
        arm = jnp.dot(jx, deq, preferred_element_type=jnp.float32)
    got = tq.quantized_dot_stacked_torch(tx, tw, 1, torch.float32)
    _close(got, want)
    _close(got, arm[:, :N])


def _layer_forms(cfg):
    """(D, N) of the five layer products and the vocab head of a config."""
    lc = cfg.llm
    D, I, hd = lc.hidden_size, lc.intermediate_size, lc.head_dim
    qkv = lc.num_attention_heads * hd + 2 * lc.num_key_value_heads * hd
    return [(D, qkv), (lc.num_attention_heads * hd, D), (D, I), (D, I),
            (I, D), (D, lc.vocab_size)]


PLAN_M = [1, 2, 3, 8, 9, 16, 17, 119, 2048, 2167]


@pytest.mark.parametrize("preset", ["internvl2_2b", "internvl2_5_8b"])
def test_launch_plan_covers_every_form(preset):
    """Every product of InternVL2-2B and InternVL2.5-8B at decode, session
    and prefill M, int8 and int4: each row of the depth lies in exactly one
    split (M > 16: one split), int4 split edges on multiples of the group,
    the grid covers Npad and M, the workspace matches the grid, and M <= 16
    launches at least two blocks a SM."""
    from v2pe_tpu_torch import config

    for D, N in _layer_forms(getattr(config, preset)()):
        npad = N + (-N) % tq.LANE
        for int4 in (False, True):
            gs = tq.int4_group_size(D) if int4 else 0
            K = D // 2 if int4 else D
            for M in PLAN_M:
                plan = tq.launch_plan(M, D, npad, gs, int4)
                form = (preset, D, N, M, int4, plan)
                if M > tq.STRIP_MAX_M:
                    assert plan.body == 1, form
                    assert plan.grid[0] * tq.TC_TILE >= M > \
                        (plan.grid[0] - 1) * tq.TC_TILE, form
                    assert plan.grid[1] * tq.TC_TILE == npad, form
                    assert len(plan.grid) == 2, form
                    # a block walks the whole depth
                    assert plan.splits == 1 and plan.split_rows == K, form
                else:
                    assert plan.body == 0 and plan.mt == (
                        8 if M <= 8 else 16), form
                    assert plan.grid == (npad // plan.bn, plan.splits), form
                    assert plan.grid[0] * plan.grid[1] >= 2 * tq.SMS, form
                    assert plan.split_rows <= tq.STRIP_ROWS[int4], form
                covered = np.zeros(K, np.int64)
                for s in range(plan.splits):
                    lo = s * plan.split_rows
                    assert lo < K, form  # no empty split
                    covered[lo:lo + plan.split_rows] += 1
                    if int4 and plan.body == 0:
                        assert lo % gs == 0, form
                assert (covered == 1).all(), form
                assert plan.ws_bytes == (4 * plan.splits * M * npad
                                         if plan.splits > 1 else 0), form


@pytest.mark.parametrize("M,D,Npad,gs,int4", [
    (1, 256, 300, 0, False),     # Npad not a multiple of 128
    (1, 255, 384, 1, True),      # odd depth for int4
    (3, 256, 384, 48, True),     # gs does not divide D/2
    (0, 256, 384, 0, False),     # no rows
    (3, 256, 384, 0, True),      # no group
])
def test_launch_plan_refuses_what_the_kernels_do_not_take(M, D, Npad, gs,
                                                          int4):
    with pytest.raises(ValueError):
        tq.launch_plan(M, D, Npad, gs, int4)


def test_products_refuse_what_they_do_not_take():
    w8 = tq.quantize_weight(torch.randn(3, 64, 32))
    x = torch.randn(2, 64)
    with pytest.raises(ValueError):  # a stack where a 2-D weight belongs
        tq.quantized_dot(x, w8)
    with pytest.raises(ValueError):
        tq.quantized_dot_stacked(x, w8, 3)  # layer outside the stack
    with pytest.raises(ValueError):
        tq.quantized_dot_stacked(torch.randn(2, 32), w8, 0)  # depth
    with pytest.raises(TypeError):
        tq.quantized_dot(x, torch.randn(64, 32))
    with pytest.raises(RuntimeError, match="no gradient"):
        tq.quantized_dot_stacked(x.requires_grad_(), w8, 0)
    meta = tq.empty_weight(8, (64, 32), device="meta")
    with pytest.raises(ValueError, match="no qdot kernel"):  # no fallback
        tq.quantized_dot(torch.randn(2, 64, device="meta"), meta)


def test_scale_stays_fp32_when_the_model_is_cast():
    w4 = tq.quantize_weight_int4(torch.randn(64, 32))
    w4.to(torch.bfloat16)
    assert w4.scale.dtype == torch.float32 and w4.p.dtype == torch.int8


# ---------------------------------------------------------------- models


def _cfg(vocab=301, bias=False):
    """D 256 keeps int4 groups of 128 (wqkv, wo, w1, w3, the head); I 96
    shrinks w2's to gcd(128, 48) = 16; vocab 301 pads to 384."""
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=256, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, qkv_bias=bias),
        rope_pos_id_stride=2, max_dynamic_patch=4)


def _jax_params(cfg, seed):
    """JAX parameters; the wqkv kernel is sharpened so that the random
    init's attention is not near uniform and tokens depend on positions."""
    params = jax_init(jax.random.PRNGKey(seed), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 10.0
    if "wqkv_bias" in layers:
        layers["wqkv_bias"] = layers["wqkv_bias"] + 0.1
    return {**params, "llm": {**params["llm"], "layers": layers}}


def _quantized_pair(cfg, seed, wd):
    """(JAX params with a quantized llm, the port's model built from that
    tree by from_jax_params): the same codes and scales on both sides."""
    params = _jax_params(cfg, seed)
    qparams = {**params, "llm": jq.quantize_llm_params(params["llm"],
                                                       bits=BITS[wd])}
    return qparams, from_jax_params(jax.tree.map(np.asarray, qparams),
                                    port_config(cfg))


@pytest.fixture(scope="module", params=["int8", "int4"])
def pair(request):
    cfg = _cfg()
    return (cfg, port_config(cfg), request.param,
            *_quantized_pair(cfg, 0, request.param))


def _leaf(w):
    return w.p if hasattr(w, "p") else w.q


def test_from_jax_params_carries_codes_and_scales(pair):
    cfg, pcfg, wd, qparams, model = pair
    llm = model.llm
    assert isinstance(llm, internlm2.QuantizedInternLM2)
    kind = tq.Int4Weight if wd == "int4" else tq.QuantizedWeight
    jl = qparams["llm"]
    for name in tq.QUANT_WEIGHT_NAMES:
        ours, theirs = llm.stacks[name], jl["layers"][name + "_kernel"]
        assert isinstance(ours, kind) and ours.payload.ndim == 3
        np.testing.assert_array_equal(ours.payload.numpy(),
                                      np.asarray(_leaf(theirs)))
        np.testing.assert_array_equal(ours.scale.numpy(),
                                      np.asarray(theirs.scale))
        assert ours.n_out == theirs.n_out
        ref = llm.layers[1]
        assert getattr(ref, name).qw is ours and getattr(ref, name).li == 1
    np.testing.assert_array_equal(llm.output.payload.numpy(),
                                  np.asarray(_leaf(jl["output_kernel"])))
    assert llm.output.n_out == 301 and llm.output.payload.shape[-1] == 384
    if wd == "int4":
        assert llm.stacks["w2"].group_size == 16
        assert llm.stacks["w1"].group_size == llm.output.group_size == 128
    # the map names every tensor of the quantized model once
    names = set(jax_leaf_map(pcfg, BITS[wd]))
    assert names == set(model.state_dict())


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_quantize_llm_params_matches_jax_tree(wd):
    """The port's own quantize_llm_params on the unquantized port model
    gives the codes and scales JAX's gives on the JAX tree; it is
    idempotent, shares the unquantized parameters, leaves the source model
    as it was, and refuses other widths."""
    cfg = _cfg(bias=True)
    params = _jax_params(cfg, 1)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_config(cfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qllm = tq.quantize_llm_params(model.llm, bits=BITS[wd])
    jl = jq.quantize_llm_params(params["llm"], bits=BITS[wd])
    for name in tq.QUANT_WEIGHT_NAMES:
        np.testing.assert_array_equal(
            qllm.stacks[name].payload.numpy(),
            np.asarray(_leaf(jl["layers"][name + "_kernel"])))
        np.testing.assert_array_equal(
            qllm.stacks[name].scale.numpy(),
            np.asarray(jl["layers"][name + "_kernel"].scale))
    np.testing.assert_array_equal(qllm.output.payload.numpy(),
                                  np.asarray(_leaf(jl["output_kernel"])))
    np.testing.assert_array_equal(qllm.output.scale.numpy(),
                                  np.asarray(jl["output_kernel"].scale))
    assert tq.quantize_llm_params(qllm, bits=BITS[wd]) is qllm
    assert tq.quantize_llm_params(qllm, bits=12 - BITS[wd]) is qllm
    assert qllm.tok_embeddings is model.llm.tok_embeddings
    assert qllm.layers[0].wqkv_bias is model.llm.layers[0].wqkv.bias
    assert qllm.layers[1].ffn_norm is model.llm.layers[1].ffn_norm
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for bits in (2, 16, 0):
        with pytest.raises(ValueError):
            tq.quantize_llm_params(model.llm, bits=bits)
    # and the quantized model from the port's quantizer computes what the
    # one carried over from JAX does (the bias is added outside the kernel)
    qparams = {**params, "llm": jl}
    ids = np.random.default_rng(5).integers(0, 301, (1, 19))
    want, _ = jax_llm_forward(qparams["llm"], cfg.llm,
                              input_ids=jnp.asarray(ids), attn_impl="jnp")
    with torch.inference_mode():
        got, _ = internlm2.llm_forward(qllm, port_config(cfg).llm,
                                       input_ids=torch.from_numpy(ids))
    _close(got.numpy(), want, LOGIT_TOL)


def test_llm_forward_logits_match_jax(pair):
    """No cache, a dense cache (prefill then decode steps) and a paged one,
    against JAX on the same quantized tree."""
    cfg, pcfg, wd, qparams, model = pair
    ids = np.random.default_rng(2).integers(0, 301, (1, 30))
    pos = np.arange(30, dtype=np.float32)[None] * 0.75
    want, _ = jax_llm_forward(qparams["llm"], cfg.llm,
                              input_ids=jnp.asarray(ids),
                              rope_pos_ids=jnp.asarray(pos), attn_impl="jnp")
    with torch.inference_mode():
        got, _ = internlm2.llm_forward(model.llm, pcfg.llm,
                                       input_ids=torch.from_numpy(ids),
                                       rope_pos_ids=torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == (1, 30, 301)
    _close(got.numpy(), want, LOGIT_TOL)

    from v2pe_tpu.models.internlm2 import KVCache as JaxKVCache

    jc = JaxKVCache.zeros(cfg.llm, 1, 30, dtype=jnp.float32)
    tc = internlm2.KVCache.zeros(pcfg.llm, 1, 30, dtype=torch.float32)
    with torch.inference_mode():
        for t0, t1 in [(0, 24)] + [(t, t + 1) for t in range(24, 28)] \
                + [(28, 30)]:
            jl, jc = jax_llm_forward(
                qparams["llm"], cfg.llm, input_ids=jnp.asarray(ids[:, t0:t1]),
                rope_pos_ids=jnp.asarray(pos[:, t0:t1]), kv_cache=jc,
                attn_impl="jnp")
            tl, tc = internlm2.llm_forward(
                model.llm, pcfg.llm, input_ids=torch.from_numpy(ids[:, t0:t1]),
                rope_pos_ids=torch.from_numpy(pos[:, t0:t1]), kv_cache=tc)
            _close(tl.numpy(), jl, LOGIT_TOL)


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_quantized_logits_stay_near_the_unquantized_model(wd):
    """The quantization itself, on the plain random init (as the JAX
    package's own tests hold it): logits within a few percent of the range of the
    unquantized model's."""
    cfg = port_config(_cfg())
    full = from_jax_params(jax.tree.map(
        np.asarray, jax_init(jax.random.PRNGKey(0), _cfg())), cfg)
    qllm = tq.quantize_llm_params(full.llm, bits=BITS[wd])
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 301, (1, 24)))
    with torch.inference_mode():
        ref, _ = internlm2.llm_forward(full.llm, cfg.llm, input_ids=ids)
        got, _ = internlm2.llm_forward(qllm, cfg.llm, input_ids=ids)
    # round-to-nearest on Gaussian weights: a code's error is about 0.4% of
    # a weight's spread in int8 and 12% in int4 (groups of 128)
    limit = {"int8": 0.05, "int4": 0.35}[wd]
    assert (got - ref).abs().max() < limit * ref.abs().max()
    if wd == "int8":
        assert (got.argmax(-1) == ref.argmax(-1)).float().mean() > 0.75


def test_a_gradient_through_a_quantized_model_raises(pair):
    cfg, pcfg, wd, qparams, model = pair
    ids = torch.arange(5)[None]
    with pytest.raises(RuntimeError, match="no gradient"):
        internlm2.llm_forward(model.llm, pcfg.llm, input_ids=ids)


def _batch(cfg):
    """Two right-padded prompts: row 0 holds one image tile at fractional
    V2PE positions, row 1 is shorter text."""
    nit = cfg.num_image_token
    row0 = np.concatenate([np.arange(10, 20), [290], [IMG] * nit, [292],
                           np.arange(30, 35)])
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


def _margins(model, pcfg, ids, plen, tokens, lens):
    """Top-2 logit margin over the logits' range at every greedy step of the
    text row (row 1), teacher-forced through the port's no-cache forward."""
    n, m = int(plen[1]), int(lens[1])
    seq = np.concatenate([ids[1, :n], tokens[1, :m]])[None]
    with torch.inference_mode():
        logits, _ = internlm2.llm_forward(model.llm, pcfg.llm,
                                          input_ids=torch.from_numpy(seq))
    steps = logits[0, n - 1:n - 1 + m]
    top = steps.topk(2, dim=-1).values
    return ((top[:, 0] - top[:, 1]) / steps.abs().max()).numpy()


@pytest.mark.parametrize("cache", ["dense", "paged", "paged_int8"])
def test_generate_tokens_match_jax(pair, cache):
    """A ragged batch (an image row and a text row) decodes greedily over
    the dense cache, the paged one (pages of 4) and the paged one with an
    int8 pool: tokens, steps and lengths identical to JAX's."""
    cfg, pcfg, wd, qparams, model = pair
    ids, plen, pos, pixels, flags = _batch(cfg)
    gc = dict(max_new_tokens=7, eos_token_ids=(7,))
    kw = {} if cache == "dense" else dict(
        cache_mode="paged", page_size=4,
        kv_dtype="int8" if cache == "paged_int8" else None)
    jt, jn, jl = jax_generate(
        qparams, cfg, JaxGenerationConfig(**gc), jnp.asarray(ids),
        jnp.asarray(plen), jnp.asarray(pos), jnp.asarray(pixels),
        jnp.asarray(flags), IMG, attn_impl="jnp", **kw)
    tt, tn, tl = generate(
        model, pcfg, GenerationConfig(**gc), torch.from_numpy(ids),
        torch.from_numpy(plen), torch.from_numpy(pos),
        torch.from_numpy(pixels), torch.from_numpy(flags), IMG, **kw)
    if cache == "dense":  # the tie rule: no step of this input is a tie
        assert _margins(model, pcfg, ids, plen, tt.numpy(),
                        tl.numpy()).min() > LOGIT_TOL
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tn == int(jn)


def test_stream_generate_equals_generate(pair):
    cfg, pcfg, wd, qparams, model = pair
    ids, plen, pos, pixels, flags = _batch(cfg)
    gc = GenerationConfig(max_new_tokens=9)
    for kw in ({}, dict(cache_mode="paged", page_size=8)):
        tokens, _, lens = generate(
            model, pcfg, gc, torch.from_numpy(ids[:1]),
            torch.from_numpy(plen[:1]), torch.from_numpy(pos[:1]),
            torch.from_numpy(pixels[:1]), torch.from_numpy(flags[:1]), IMG,
            **kw)
        chunks = list(stream_generate(model, pcfg, gc, ids[:1], pos[:1],
                                      pixels[:1], flags[:1], IMG, chunk=4,
                                      **kw))
        np.testing.assert_array_equal(np.concatenate(chunks),
                                      tokens[0, :int(lens[0])].numpy())


# ------------------------------------------------- chat, session, worker


@pytest.fixture(scope="module", params=["int8", "int4"])
def chats(request):
    """(JAX ChatModel, port ChatModel) with ``weights_dtype`` set, paged
    with pages of 8: each quantizes its own unquantized weights at
    construction (the same fp32 arrays), so this also holds the port's
    quantizer to JAX's inside the served path."""
    tok = _toy_tokenizer()
    cfg = _cfg(vocab=len(tok))
    params = _jax_params(cfg, 4)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_config(cfg))
    kw = dict(cache_mode="paged", page_size=8, weights_dtype=request.param)
    return (JaxChatModel(params, cfg, tok, attn_impl="jnp", **kw),
            ChatModel(model, port_config(cfg), tok, **kw), model)


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), dtype=np.uint8))


def test_chat_model_quantizes_at_construction(chats):
    jchat, tchat, model = chats
    assert tchat.weights_dtype == jchat.weights_dtype
    assert isinstance(tchat.model.llm, internlm2.QuantizedInternLM2)
    assert tchat.model.vision is model.vision  # the ViT stays as it is
    assert tchat.model.mlp1 is model.mlp1
    assert isinstance(model.llm, internlm2.InternLM2Model)  # and the source
    jw = jchat.params["llm"]["layers"]["w2_kernel"]
    np.testing.assert_array_equal(tchat.model.llm.stacks["w2"].payload.numpy(),
                                  np.asarray(_leaf(jw)))


def test_chat_and_batch_chat_match_jax(chats):
    jchat, tchat, _ = chats
    pixels, n = tchat.load_pixels(_image(0, 80, 120), max_num=4)
    got = tchat.chat(pixels, "What is this?", GenerationConfig(
        max_new_tokens=8), return_history=True, num_patches_list=[n])
    want = jchat.chat(pixels, "What is this?", JaxGenerationConfig(
        max_new_tokens=8), return_history=True, num_patches_list=[n])
    assert got == want
    qs = ["Say A.", "Count to three, please."]
    assert tchat.batch_chat(None, qs, GenerationConfig(max_new_tokens=6)) \
        == jchat.batch_chat(None, qs, JaxGenerationConfig(max_new_tokens=6))


def test_dense_chat_matches_jax(chats):
    jchat, tchat, _ = chats
    jdense = JaxChatModel(jchat.params, jchat.cfg, jchat.tokenizer,
                          attn_impl="jnp")
    tdense = ChatModel(tchat.model, tchat.cfg, tchat.tokenizer)
    q = "Name a colour."
    assert tdense.chat(None, q, GenerationConfig(max_new_tokens=6)) == \
        jdense.chat(None, q, JaxGenerationConfig(max_new_tokens=6))


def test_session_turns_match_jax(chats):
    """An image turn into an empty pool, then two turns that prefill only
    their suffix over the pool."""
    jchat, tchat, _ = chats
    kw = dict(max_len=2048, page_size=8, chunk_multiple=64)
    jsess, tsess = JaxChatSession(jchat, **kw), ChatSession(tchat, **kw)
    for img, q in [(_image(1, 64, 80), "One."), (None, "Two."),
                   (None, "Three?")]:
        pv = None if img is None else tchat.load_pixels(img)[0]
        want = jsess.send(pv, q, JaxGenerationConfig(max_new_tokens=5))
        got = tsess.send(pv, q, GenerationConfig(max_new_tokens=5))
        assert got == want, q
    assert tsess.consumed == jsess.consumed > 0


def test_worker_text_route_matches_jax(chats):
    jchat, tchat, _ = chats
    payload = {"prompt": "<|im_start|>user\nCount to three.<|im_end|>"
                         "<|im_start|>assistant\n",
               "max_new_tokens": 10, "temperature": 0.0}
    out = []
    for worker in (JaxModelWorker(jchat, model_name="tiny"),
                   ModelWorker(tchat, model_name="tiny")):
        server = worker.make_server(host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}"
                f"/worker_generate_stream", data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                out.append([json.loads(c) for c in r.read().split(b"\0")
                            if c])
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    want, got = out
    assert got == want
    assert all(c["error_code"] == 0 for c in got) and len(got) >= 2
