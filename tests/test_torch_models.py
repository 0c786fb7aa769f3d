"""Parity of the PyTorch port's models (v2pe_tpu_torch/models) with the JAX
package on the CPU in fp32: ViT, InternLM2 without and with the dense KV
cache, the composite model's logits, and the parameter conversion. Weights
come from the JAX init, converted with from_jax_params."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.models import intern_vit as jvit
from v2pe_tpu.models import internlm2 as jlm
from v2pe_tpu.models import internvl_chat as jchat
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu_torch.models import intern_vit as tvit
from v2pe_tpu_torch.models import internlm2 as tlm
from v2pe_tpu_torch.models import internvl_chat as tchat
from v2pe_tpu_torch.models.params import (_jax_state_dict, from_jax_params,
                                          init_vlm_params)

from .torch_parity import run_parity

# fp32 end to end; the two frameworks sum in other orders
TOL = dict(atol=2e-5, rtol=2e-5)
IMG = 291  # <IMG_CONTEXT> id in the tiny vocab


def _cfg(**vision):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14, **vision),
        llm=LLMConfig(vocab_size=300, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2),
        rope_pos_id_stride=2)


def _models(cfg, seed=0):
    params = jax_init(jax.random.PRNGKey(seed), cfg)
    return params, from_jax_params(jax.tree.map(np.asarray, params), cfg)


def _pixels(n, size=56, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("variant", ["layer_norm", "rms_qknorm",
                                     "interp_select"])
def test_vit_matches_jax(variant):
    vision = {"rms_qknorm": dict(norm_type="rms_norm",
                                 qk_normalization=True, qkv_bias=False)
              }.get(variant, {})
    cfg = _cfg(**vision)
    params, model = _models(cfg)
    # 84 px tiles resize the 4x4 position grid to 6x6 (bicubic)
    size = 84 if variant == "interp_select" else 56
    select = -2 if variant == "interp_select" else -1
    with torch.no_grad():
        p = run_parity(
            lambda x: jvit.vision_forward(params["vision"], cfg.vision, x,
                                          select_layer=select,
                                          attn_impl="jnp"),
            lambda x: tvit.vision_forward(model.vision, cfg.vision, x,
                                          select_layer=select),
            _pixels(3, size))
    p.assert_close(**TOL)


def test_interpolate_pos_embed_matches_jax():
    grid = np.random.default_rng(1).standard_normal((1, 32 * 32, 8)).astype(
        np.float32)
    p = run_parity(lambda g: jvit.interpolate_pos_embed(g, 32, 24, 40),
                   lambda g: tvit.interpolate_pos_embed(g, 32, 24, 40), grid)
    p.assert_close(**TOL)


@pytest.mark.parametrize("ps_version", ["v1", "v2"])
def test_pixel_shuffle_and_pooled_features_match_jax(ps_version):
    cfg = dataclasses.replace(_cfg(), ps_version=ps_version,
                              img_emb_down_sample_ratio=2)
    params, model = _models(cfg)
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 12)).astype(
        np.float32)
    with torch.no_grad():
        p = run_parity(
            lambda x, px: (jchat.pixel_shuffle(x, 0.5, ps_version),
                           jchat.extract_feature(params, cfg, px,
                                                 attn_impl="jnp")),
            lambda x, px: (tchat.pixel_shuffle(x, 0.5, ps_version),
                           tchat.extract_feature(model, cfg, px)),
            x, _pixels(2))
    p.assert_close(**TOL)


def test_scatter_image_embeds_match_jax():
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((2, 12, 5)).astype(np.float32)
    vit = rng.standard_normal((3, 4, 5)).astype(np.float32)
    ids = rng.integers(0, 10, (2, 12)).astype(np.int32)
    ids[0, 2:6] = IMG
    ids[1, 5:9] = IMG
    flags = np.array([0, 1, 1], np.int32)  # tile 0 is padding
    gather = np.full((2, 12), -1, np.int32)
    gather[0, 2:6] = np.arange(4, 8)
    gather[1, 5:9] = np.arange(8, 12)
    p = run_parity(
        lambda e, i, v, f, g: (
            jchat.scatter_image_embeds(e, i, v, f, IMG),
            jchat.scatter_image_embeds_by_index(e, v, g)),
        lambda e, i, v, f, g: (
            tchat.scatter_image_embeds(e, i, v, f, IMG),
            tchat.scatter_image_embeds_by_index(e, v, g)),
        embeds, ids, vit, flags, gather)
    p.assert_close(atol=0, rtol=0)
    np.testing.assert_array_equal(p.torch[0], p.torch[1])


def _packed_text(B=2, S=40, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 290, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    seg[:, :22], seg[:, 22:36] = 1, 2  # 4 padding slots at the end
    rope = np.zeros((B, S), np.float32)
    rope[:, :22] = np.concatenate([np.arange(6), 5 + 0.5 * np.arange(1, 17)])
    rope[:, 22:36] = np.arange(14)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return ids, seg, rope, pos


def test_llm_forward_no_cache_matches_jax():
    """Packed rows: segments, fractional V2PE ids, q-rotary fused into the
    flash call."""
    cfg = _cfg()
    params, model = _models(cfg, seed=1)
    ids, seg, rope, pos = _packed_text()
    with torch.no_grad():
        p = run_parity(
            lambda i, s, r, t: jlm.llm_forward(
                params["llm"], cfg.llm, input_ids=i, rope_pos_ids=r,
                segment_ids=s, positions=t, attn_impl="jnp")[0],
            lambda i, s, r, t: tlm.llm_forward(
                model.llm, cfg.llm, input_ids=i.long(), rope_pos_ids=r,
                segment_ids=s, positions=t)[0],
            ids, seg, rope, pos)
    valid = seg != 0
    p.assert_close(**TOL, masks=[valid])


@pytest.mark.parametrize("rope_mode", ["v2pe", "dynamic"])
def test_llm_forward_kv_cache_matches_jax(rope_mode):
    """Prefill of a right-padded batch into the dense cache (through the
    flash path), then two one-token decode steps (the two-part einsum),
    with the cache contents compared after each call."""
    cfg = dataclasses.replace(_cfg(), llm=dataclasses.replace(
        _cfg().llm, rope_mode=rope_mode, rope_scaling_factor=2.0,
        max_position_embeddings=24))
    params, model = _models(cfg, seed=2)
    B, S, T = 2, 20, 2
    max_len = S + T
    ids = np.random.default_rng(5).integers(3, 290, (B, S)).astype(np.int32)
    # text, a visual run at stride 1/2, text
    rope = np.concatenate([np.arange(6), 5 + 0.5 * np.arange(1, 9),
                           9 + np.arange(1, 7)]).astype(np.float32)
    rope = np.repeat(rope[None], B, 0)
    plen = np.array([20, 17], np.int32)
    slot = np.arange(max_len)[None]

    def valid_at(t):
        return (slot < plen[:, None]) | ((slot >= S) & (slot < S + t))

    steps = np.array([[7, 8], [9, 10]], np.int32)

    def jax_run(ids, rope, steps):
        cache = jlm.KVCache.zeros(cfg.llm, B, max_len, dtype=jnp.float32)
        outs = []
        logits, cache = jlm.llm_forward(
            params["llm"], cfg.llm, input_ids=ids, rope_pos_ids=rope,
            kv_cache=cache, kv_valid=jnp.asarray(valid_at(0)),
            attn_impl="jnp")
        outs += [logits, cache.k, cache.v]
        for t in range(T):
            logits, cache = jlm.llm_forward(
                params["llm"], cfg.llm, input_ids=steps[:, t:t + 1],
                rope_pos_ids=rope[:, -1:] + 1.0 + t, kv_cache=cache,
                kv_valid=jnp.asarray(valid_at(t + 1)), attn_impl="jnp")
            outs += [logits, cache.k, cache.v]
        return outs

    def torch_run(ids, rope, steps):
        cache = tlm.KVCache.zeros(cfg.llm, B, max_len, dtype=torch.float32)
        outs = []
        with torch.no_grad():
            logits, cache = tlm.llm_forward(
                model.llm, cfg.llm, input_ids=ids.long(), rope_pos_ids=rope,
                kv_cache=cache, kv_valid=torch.from_numpy(valid_at(0)))
            outs += [logits, cache.k.clone(), cache.v.clone()]
            for t in range(T):
                logits, cache = tlm.llm_forward(
                    model.llm, cfg.llm, input_ids=steps[:, t:t + 1].long(),
                    rope_pos_ids=rope[:, -1:] + 1.0 + t, kv_cache=cache,
                    kv_valid=torch.from_numpy(valid_at(t + 1)))
                outs += [logits, cache.k.clone(), cache.v.clone()]
        assert cache.length == S + T
        return outs

    p = run_parity(jax_run, torch_run, ids, rope, steps)
    # row 1's padded prompt slots hold keys nobody reads; compare the rest
    prefill_valid = np.ones((B, S), bool)
    prefill_valid[1, 17:] = False
    kv_valid = np.broadcast_to(valid_at(T)[None, :, :, None, None],
                               (2, B, max_len, 2, 8))
    masks = [prefill_valid, kv_valid, kv_valid] + [None, kv_valid,
                                                    kv_valid] * T
    p.assert_close(**TOL, masks=masks)


def test_full_model_logits_match_jax():
    cfg = _cfg()
    params, model = _models(cfg, seed=3)
    nit = cfg.num_image_token
    ids = np.concatenate([np.arange(10, 20), [290], [IMG] * (2 * nit), [292],
                          np.arange(30, 45)]).astype(np.int32)[None]
    S = ids.shape[1]
    rope = np.arange(S, dtype=np.float32)[None]
    rope[0, 11:11 + 2 * nit] = 10 + 0.5 * np.arange(1, 2 * nit + 1)
    rope[0, 11 + 2 * nit:] = rope[0, 10 + 2 * nit] + np.arange(
        1, S - 10 - 2 * nit)
    seg = np.ones((1, S), np.int32)
    seg[0, -5:] = 2
    pos = np.arange(S, dtype=np.int32)[None]
    flags = np.ones(2, np.int32)
    with torch.no_grad():
        p = run_parity(
            lambda i, px, f, r, s, t: jchat.forward(
                params, cfg, input_ids=i, pixel_values=px, image_flags=f,
                rope_pos_ids=r, img_context_token_id=IMG, segment_ids=s,
                token_positions=t, attn_impl="jnp").logits,
            lambda i, px, f, r, s, t: tchat.forward(
                model, cfg, input_ids=i.long(), pixel_values=px,
                image_flags=f, rope_pos_ids=r, img_context_token_id=IMG,
                segment_ids=s, token_positions=t).logits,
            ids, _pixels(2), flags, rope, seg, pos)
    p.assert_close(**TOL)


def test_init_matches_jax_shapes_and_scales():
    cfg = _cfg()
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), cfg))
    model = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    want = {k: v.shape for k, v in _jax_state_dict(jparams, cfg).items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    sd = model.state_dict()
    assert torch.all(sd["vision.layers.0.ls1"] == 0.1)
    assert torch.all(sd["llm.layers.1.attention_norm"] == 1.0)
    assert torch.all(sd["mlp1.fc1.bias"] == 0.0)
    std = sd["llm.tok_embeddings.weight"].std().item()
    assert 0.018 < std < 0.022
    assert 0.8 < sd["vision.embeddings.position_embedding"].std().item() < 1.2
    again = init_vlm_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), again.state_dict().values()))
