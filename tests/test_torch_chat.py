"""Greedy decoding of the PyTorch port against the JAX package on the CPU:
generate (ragged batch, image and text rows), ChatModel.chat with the toy
tokenizer, and stream_generate against generate. Tokens must be identical.
Each test calls the JAX generate at most once per shape (its decode loop is
a heavy compile)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig, _sample, generate
from v2pe_tpu_torch.infer.streaming import stream_generate
from v2pe_tpu_torch.models.params import from_jax_params

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config

IMG = 291


def _cfg(vocab=300):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2),
        rope_pos_id_stride=2)


def _models(cfg, seed, qkv_scale=1.0):
    """JAX params and the port's model from them. qkv_scale sharpens the
    attention of the random init, whose 0.02-scale scores are nearly
    uniform, so that the tokens depend on the positions."""
    params = jax_init(jax.random.PRNGKey(seed), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * qkv_scale
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    return params, from_jax_params(jax.tree.map(np.asarray, params),
                                   port_config(cfg))


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
    flags = np.array([1, 0], np.int32)
    return ids, plen, pos, pixels, flags


def test_generate_greedy_matches_jax():
    cfg = _cfg()
    params, model = _models(cfg, seed=0, qkv_scale=30.0)
    ids, plen, pos, pixels, flags = _batch(cfg)
    gc = dict(max_new_tokens=6, eos_token_ids=(7,))
    jt, jn, jl = jax_generate(
        params, cfg, JaxGenerationConfig(**gc), jnp.asarray(ids),
        jnp.asarray(plen), jnp.asarray(pos), jnp.asarray(pixels),
        jnp.asarray(flags), IMG, attn_impl="jnp")
    tt, tn, tl = generate(
        model, cfg, GenerationConfig(**gc), torch.from_numpy(ids),
        torch.from_numpy(plen), torch.from_numpy(pos),
        torch.from_numpy(pixels), torch.from_numpy(flags), IMG)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tn == int(jn)


def test_chat_matches_jax():
    from PIL import Image

    tok = _toy_tokenizer()
    cfg = _cfg(vocab=len(tok))
    params, model = _models(cfg, seed=2, qkv_scale=30.0)
    jchat = JaxChatModel(params, cfg, tok, attn_impl="jnp")
    tchat = ChatModel(model, port_config(cfg), tok)
    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (100, 160, 3), dtype=np.uint8))
    pixels, n_tiles = tchat.load_pixels(img, max_num=4)
    np.testing.assert_array_equal(pixels, jchat.load_pixels(img, max_num=4)[0])
    q = "What is in the image?"
    assert tchat.encode_chat("<image>\n" + q, [n_tiles])[2] == \
        jchat.encode_chat("<image>\n" + q, [n_tiles])[2]

    gc_t = GenerationConfig(max_new_tokens=6)
    gc_j = JaxGenerationConfig(max_new_tokens=6)
    got = tchat.chat(pixels, q, gc_t, return_history=True,
                     num_patches_list=[n_tiles])
    want = jchat.chat(pixels, q, gc_j, return_history=True,
                      num_patches_list=[n_tiles])
    assert got == want
    assert got[1][-1][0] == "<image>\n" + q
    # text only, through batch_chat
    assert tchat.batch_chat(None, ["What is 2 plus 2?"], gc_t) == \
        jchat.batch_chat(None, ["What is 2 plus 2?"], gc_j)


def test_stream_generate_equals_generate():
    cfg = _cfg()
    _, model = _models(cfg, seed=1, qkv_scale=30.0)
    ids, plen, pos, pixels, flags = _batch(cfg)
    gc = GenerationConfig(max_new_tokens=9)
    tokens, _, lens = generate(
        model, port_config(cfg), gc, torch.from_numpy(ids[:1]), torch.from_numpy(plen[:1]),
        torch.from_numpy(pos[:1]), torch.from_numpy(pixels[:1]),
        torch.from_numpy(flags[:1]), IMG)
    chunks = list(stream_generate(model, port_config(cfg), gc, ids[:1], pos[:1],
                                  pixels[:1], flags[:1], IMG, chunk=4))
    assert [len(c) for c in chunks] == [1, 4, 4]
    np.testing.assert_array_equal(np.concatenate(chunks),
                                  tokens[0, :int(lens[0])].numpy())


def test_sampling_follows_the_generator():
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    greedy = _sample(logits, GenerationConfig(), None)
    assert torch.equal(greedy, logits.argmax(-1))
    gc = GenerationConfig(do_sample=True, temperature=0.7, top_k=5,
                          top_p=0.9)
    a = _sample(logits, gc, torch.Generator().manual_seed(1))
    b = _sample(logits, gc, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    top5 = logits.topk(5, dim=-1).indices
    assert all(int(a[i]) in top5[i].tolist() for i in range(3))
    one = dataclasses.replace(gc, top_k=1)
    assert torch.equal(_sample(logits, one, torch.Generator()), greedy)


def test_unported_options_raise():
    tok = _toy_tokenizer()
    cfg = _cfg(vocab=len(tok))
    _, model = _models(cfg, seed=0)
    for kw in (dict(cache_mode="paged", kv_dtype="fp8"),
               dict(cache_mode="ring"), dict(cache_mode="chunked"),
               dict(weights_dtype="fp8"), dict(weights_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            ChatModel(model, port_config(cfg), tok, **kw)
    # LoRA is ported: fresh adapters (B = 0) merge to the same weights
    from v2pe_tpu_torch.models.lora import build_lora

    fresh = build_lora(torch.Generator().manual_seed(0), model, backbone_r=2,
                       llm_r=4)
    gc2 = GenerationConfig(max_new_tokens=3)
    assert ChatModel(model, port_config(cfg), tok, lora=fresh).chat(
        None, "hi", gc2) == ChatModel(model, port_config(cfg), tok).chat(
        None, "hi", gc2)
    for wd in ("int8", "int4"):  # ported: they quantize at construction
        assert ChatModel(model, port_config(cfg), tok, weights_dtype=wd).chat(
            None, "hi", GenerationConfig(max_new_tokens=2)) is not None
    # an int4 pool, beam search and speculative decoding are served
    chat = ChatModel(model, port_config(cfg), tok, cache_mode="paged",
                     kv_dtype="int4")
    for gc in (GenerationConfig(max_new_tokens=2),
               GenerationConfig(max_new_tokens=2, num_beams=2),
               GenerationConfig(max_new_tokens=3, speculative_k=2)):
        assert isinstance(chat.chat(None, "hi", gc), str)
    ids, plen, pos, pixels, flags = _batch(cfg)
    args = (torch.from_numpy(ids), torch.from_numpy(plen),
            torch.from_numpy(pos), torch.from_numpy(pixels),
            torch.from_numpy(flags), IMG)
    for gc, kw in ((GenerationConfig(), dict(cache_mode="paged",
                                             kv_dtype="fp8")),
                   (GenerationConfig(), dict(cache_mode="ring"))):
        with pytest.raises(NotImplementedError):
            generate(model, port_config(cfg), gc, *args, **kw)
    # speculation needs the paged cache, as in JAX
    with pytest.raises(ValueError):
        generate(model, port_config(cfg), GenerationConfig(speculative_k=2),
                 *args)
