"""Prompt-lookup speculative decoding and beam search of the PyTorch port
against the JAX package on the CPU, in fp32 on a small model.

``prompt_lookup_draft`` element for element; speculative ``generate`` equal
to plain greedy ``generate`` and to JAX's speculative ``generate`` (tokens,
lengths, and the number of verify forwards); the speculative ``ChatSession``
with its adaptive per-turn switch against JAX's; ``beam_generate`` tokens
and lengths against JAX's over beam counts, length penalties and early
stopping, and ``ChatModel.chat(num_beams=...)`` against JAX's chat.

Tolerances: none; every comparison is of integers or text.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer import speculative as jspec
from v2pe_tpu.infer.beam import beam_generate as jax_beam
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.infer.session import ChatSession as JaxChatSession
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu_torch.infer import speculative as tspec
from v2pe_tpu_torch.infer.beam import beam_generate
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.infer.session import ChatSession
from v2pe_tpu_torch.models.params import from_jax_params

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config

IMG = 291


# ------------------------------------------------------------------- drafts


@pytest.mark.parametrize("k,g", [(1, 1), (3, 2), (4, 3), (15, 3)])
def test_prompt_lookup_draft_matches_jax(k, g):
    """Rows with a recent and an older match, with no match, with a match
    whose continuation runs into the row's end, and a row shorter than the
    n-gram: every drafted token equals JAX's."""
    rng = np.random.default_rng(k * 10 + g)
    B, W = 6, 48
    ctx = rng.integers(0, 5, (B, W)).astype(np.int32)   # few symbols: hits
    ctx[1] = np.arange(W)                               # no repeat: no match
    ctx[2, :20] = np.tile([7, 8, 9, 10], 5)             # periodic
    n_ctx = np.array([30, 25, 20, 47, max(g, 1), W - 1], np.int32)
    want = jspec.prompt_lookup_draft(jnp.asarray(ctx), jnp.asarray(n_ctx), k,
                                     g)
    got = tspec.prompt_lookup_draft(torch.from_numpy(ctx),
                                    torch.from_numpy(n_ctx), k, g)
    assert got.shape == (B, k) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if g <= 4 and k <= 4:   # the periodic row drafts its own continuation
        period = np.tile([7, 8, 9, 10], 8)
        np.testing.assert_array_equal(got.numpy()[2], period[20:20 + k])


def test_scatter_kept_writes_the_kept_prefix_only():
    buf = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    before = buf.clone()
    y = torch.tensor([[50, 51, 52], [60, 61, 62]], dtype=torch.int32)
    keep = torch.tensor([[True, True, False], [False, False, False]])
    tspec.scatter_kept(buf, torch.tensor([4, 9], dtype=torch.int32), y, keep)
    assert buf[0].tolist() == [0, 1, 2, 3, 50, 51, 6, 7, 8, 9, 10, 11]
    assert torch.equal(buf[1], before[1])


# ------------------------------------------------------------------- models


def _cfg(vocab=300, layers=2):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=64, intermediate_size=64,
                      num_hidden_layers=layers, num_attention_heads=4,
                      num_key_value_heads=2),
        rope_pos_id_stride=2)


def _sharpen(params):
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    return {**params, "llm": {**params["llm"], "layers": layers}}


@pytest.fixture(scope="module")
def models():
    cfg = _cfg()
    params = _sharpen(jax_init(jax.random.PRNGKey(0), cfg))
    return cfg, params, from_jax_params(jax.tree.map(np.asarray, params),
                                        port_config(cfg))


def _batch(cfg, repeat: bool):
    """Two right-padded prompts: row 0 holds one image tile at fractional
    V2PE positions (and, with ``repeat``, a repeated span that drafts can
    copy from), row 1 is shorter text."""
    nit = cfg.num_image_token
    tail = np.tile(np.arange(30, 35), 3) if repeat else np.arange(30, 35)
    row0 = np.concatenate([np.arange(10, 20), [290], [IMG] * nit, [292],
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


@pytest.mark.parametrize("K,g,kv,repeat", [(1, 1, None, False),
                                           (3, 2, None, True),
                                           (4, 3, "int8", True),
                                           (4, 2, "int4", True),
                                           (15, 3, None, False)])
def test_speculative_generate_matches_plain_and_jax(models, K, g, kv, repeat):
    """Speculative generate gives plain greedy generate's tokens and
    lengths, and JAX's speculative tokens, lengths and forward count; the
    rejected slots it wrote into the pool are overwritten or never read."""
    cfg, params, model = models
    ids, plen, pos, pixels, flags = _batch(cfg, repeat)
    base = dict(max_new_tokens=9, eos_token_ids=(7,))
    paged = dict(cache_mode="paged", page_size=4, kv_dtype=kv)
    targs = (torch.from_numpy(ids), torch.from_numpy(plen),
             torch.from_numpy(pos), torch.from_numpy(pixels),
             torch.from_numpy(flags), IMG)
    pt, _, pl = generate(model, port_config(cfg), GenerationConfig(**base),
                         *targs, **paged)
    spec = dict(base, speculative_k=K, speculative_ngram=g)
    st, sn, sl = generate(model, port_config(cfg), GenerationConfig(**spec),
                          *targs, **paged)
    np.testing.assert_array_equal(st.numpy(), pt.numpy())
    np.testing.assert_array_equal(sl.numpy(), pl.numpy())
    jt, jn, jl = jax_generate(
        params, cfg, JaxGenerationConfig(**spec), jnp.asarray(ids),
        jnp.asarray(plen), jnp.asarray(pos), jnp.asarray(pixels),
        jnp.asarray(flags), IMG, attn_impl="jnp", **paged)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(sl.numpy(), np.asarray(jl))
    assert sn == int(jn) <= int(pl.max())


def test_speculative_generate_refuses_what_jax_refuses(models):
    cfg, _, model = models
    ids, plen, pos, pixels, flags = _batch(cfg, False)
    targs = (torch.from_numpy(ids), torch.from_numpy(plen),
             torch.from_numpy(pos), torch.from_numpy(pixels),
             torch.from_numpy(flags), IMG)
    for gc, kw in ((dict(speculative_k=2), dict(cache_mode="dense")),
                   (dict(speculative_k=2, do_sample=True),
                    dict(cache_mode="paged")),
                   (dict(speculative_k=16), dict(cache_mode="paged"))):
        with pytest.raises(ValueError):
            generate(model, port_config(cfg), GenerationConfig(**gc), *targs,
                     **kw)


# ------------------------------------------------------------------ session


@pytest.fixture(scope="module")
def chats():
    """(JAX ChatModel, port ChatModel), paged with pages of 8 tokens, over
    the same weights."""
    tok = _toy_tokenizer()
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=32,
                      intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2, max_dynamic_patch=4)
    params = _sharpen(jax_init(jax.random.PRNGKey(4), cfg))
    pcfg = port_config(cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg)
    kw = dict(cache_mode="paged", page_size=8)
    return (JaxChatModel(params, cfg, tok, attn_impl="jnp", **kw),
            ChatModel(model, pcfg, tok, **kw))


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("kv", [None, "int4"])
def test_speculative_session_matches_plain_and_jax(chats, kv):
    """Five turns with speculative_k=3: each reply equals the plain
    session's and the JAX speculative session's, and the adaptive switch
    (acceptance EMA, suspended turns) moves in step with JAX's."""
    jchat, tchat = chats
    kw = dict(max_len=2048, page_size=8, chunk_multiple=64, kv_dtype=kv)
    jsess, tsess = JaxChatSession(jchat, **kw), ChatSession(tchat, **kw)
    plain = ChatSession(tchat, **kw)
    spec = dict(max_new_tokens=6, speculative_k=3, speculative_ngram=2)
    turns = [(_image(1, 64, 80), "One."), (None, "Two."), (None, "One."),
             (None, "Two."), (None, "Three?")]
    for img, q in turns:
        pv = None if img is None else tchat.load_pixels(img)[0]
        want = jsess.send(pv, q, JaxGenerationConfig(**spec))
        got = tsess.send(pv, q, GenerationConfig(**spec))
        assert got == want, q
        assert got == plain.send(pv, q, GenerationConfig(max_new_tokens=6))
        assert tsess._spec_suspended_for == jsess._spec_suspended_for
        assert (tsess._spec_accept_ema is None) == \
            (jsess._spec_accept_ema is None)
        if tsess._spec_accept_ema is not None:
            assert tsess._spec_accept_ema == pytest.approx(
                jsess._spec_accept_ema, rel=1e-6)
    assert tsess.consumed == jsess.consumed > 0
    assert int(tsess.cache.lengths[0]) == int(jsess.cache.lengths[0])
    with pytest.raises(ValueError, match="max_len"):
        ChatSession(tchat, max_len=64, page_size=8).send(
            None, "A question that does not fit. " * 3,
            GenerationConfig(max_new_tokens=8, speculative_k=3))


# --------------------------------------------------------------------- beam


@pytest.mark.parametrize("K,lp,early,eos", [(2, 1.0, False, (7,)),
                                            (3, 1.0, False, (7, 12)),
                                            (3, 0.5, True, (7,)),
                                            (4, 2.0, False, ()),
                                            (1, 1.0, False, (7,))])
def test_beam_generate_matches_jax(models, K, lp, early, eos):
    """Tokens and lengths of the best hypothesis per row equal JAX's, over
    beam counts, length penalties, early stopping and stop sets (none: the
    open beams are finalized); one beam is greedy generate."""
    cfg, params, model = models
    ids, plen, pos, pixels, flags = _batch(cfg, False)
    gc = dict(max_new_tokens=8, eos_token_ids=eos, num_beams=K,
              length_penalty=lp, early_stopping=early)
    jt, jl = jax_beam(params, cfg, JaxGenerationConfig(**gc),
                      jnp.asarray(ids), jnp.asarray(plen), jnp.asarray(pos),
                      jnp.asarray(pixels), jnp.asarray(flags), IMG,
                      attn_impl="jnp")
    targs = (torch.from_numpy(ids), torch.from_numpy(plen),
             torch.from_numpy(pos), torch.from_numpy(pixels),
             torch.from_numpy(flags), IMG)
    tt, tl = beam_generate(model, port_config(cfg), GenerationConfig(**gc),
                           *targs)
    assert tt.dtype == torch.int32 and tt.shape == (2, 8)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if K == 1:
        gt, _, gl = generate(model, port_config(cfg), GenerationConfig(
            max_new_tokens=8, eos_token_ids=eos), *targs)
        for b in range(2):
            n = int(tl[b])
            assert tt[b, :n].tolist() == gt[b, :n].tolist()
            assert int(gl[b]) in (n, n + 1)   # generate counts its eos


@pytest.mark.parametrize("K", [2, 3])
def test_chat_with_beams_matches_jax(chats, K):
    jchat, tchat = chats
    pixels, n = tchat.load_pixels(_image(0, 80, 120), max_num=4)
    for pv, q, npl in ((pixels, "What is this?", [n]),
                       (None, "Count to three, please.", None)):
        got = tchat.chat(pv, q, GenerationConfig(max_new_tokens=7,
                                                 num_beams=K),
                         num_patches_list=npl)
        want = jchat.chat(pv, q, JaxGenerationConfig(max_new_tokens=7,
                                                     num_beams=K),
                          num_patches_list=npl)
        assert got == want
