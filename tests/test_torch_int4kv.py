"""The int4 KV pool of the PyTorch port against the JAX package on the CPU.

JAX keeps an int4 pool as ``jnp.int4`` pages; the port packs two dims of one
token into a byte (``ops/paged_attention.pack_int4``), and
``torch_parity.port_paged_cache`` / ``jax_paged_cache`` carry a pool from
one form to the other. Held here: the quantizer's codes and scales bit for
bit; the three plain int4 versions (store, decode, chunked prefill) against
the Pallas kernels in interpret mode on the unpacked ``jnp.int4`` pool; the
pool helpers of ``infer/paged_kv.py``; and paged ``generate``, ``ChatModel``
and ``ChatSession`` with ``kv_dtype="int4"`` token for token. The CUDA
kernels' int4 mode is held to the plain versions on the card by
``chip_smoke.py``.

Tolerances: codes, scales, allocation and pool writes exactly equal; fp32
attention outputs over equal pools 2e-5 (the sums run in another order);
model logits 2e-5 of their range while both pools hold equal codes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer import paged_kv as jpk
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.chunked_prefill import chunked_prefill as jax_chunked
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.infer.session import ChatSession as JaxChatSession
from v2pe_tpu.models.internlm2 import llm_forward as jax_llm_forward
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.ops import paged_attention as jpa
from v2pe_tpu_torch.infer import paged_kv as tpk
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.infer.session import ChatSession
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.ops import paged_attention as tpa

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import (jax_paged_cache, port_config, port_paged_cache,
                           to_numpy)

L, HQ, HKV, HD, NP, PS = 2, 4, 2, 16, 14, 8
PAGE_TABLE = np.array([[3, 7, 1, 9, -1], [2, -1, 5, 11, -1],
                       [-1, -1, -1, -1, -1]], np.int32)
LENGTHS = np.array([19, 27, 0], np.int32)
TOL = 2e-5


def _codes(seed: int):
    """A random int4 pool as unpacked codes in [-7, 7] and fp32 scales."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, NP, PS, HD)
    k, v = (rng.integers(-7, 8, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.05, 0.4, (L, HKV, NP, 1, PS)).astype(np.float32)
              for _ in range(2))
    return k, v, ks, vs


def _jpool(k, v):
    return jnp.asarray(k).astype(jnp.int4), jnp.asarray(v).astype(jnp.int4)


def _tpool(k, v):
    return (tpa.pack_int4(torch.from_numpy(k)),
            tpa.pack_int4(torch.from_numpy(v)))


# ---------------------------------------------------------------- quantizer


@pytest.mark.parametrize("shape", [(3, 4, 16), (2, 1, 2, 128), (5, 64)])
def test_quantize_kv_int4_matches_jax_bit_for_bit(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32) * 3
    x[0, 0] = 0.0                                    # amax 0 -> scale 1
    x.reshape(-1, shape[-1])[1, :8] = [7, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -7]
    jq, js = jpk.quantize_kv(jnp.asarray(x), 4)
    tq, ts = tpa.quantize_kv(torch.from_numpy(x), 4)
    assert jq.dtype == jnp.int4 and tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.astype(jnp.int8)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tq.abs().max()) == 7
    with pytest.raises(ValueError):
        tpa.quantize_kv(torch.from_numpy(x), bits=2)


def test_pack_int4_layout_and_round_trip():
    """Byte d holds dim d in its low nibble and dim d + hd/2 in its high
    one, signs kept; unpack inverts pack over every pair of codes."""
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8), indexing="ij")
    codes = torch.from_numpy(
        np.stack([lo.ravel(), hi.ravel()], axis=-1).astype(np.int8))
    packed = tpa.pack_int4(codes)
    assert packed.shape == (225, 1) and packed.dtype == torch.int8
    b = packed[:, 0].to(torch.int32)
    assert torch.equal(((b & 0xF) ^ 8) - 8, codes[:, 0].to(torch.int32))
    assert torch.equal(b >> 4, codes[:, 1].to(torch.int32))
    assert torch.equal(tpa.unpack_int4(packed), codes)
    wide = torch.from_numpy(np.random.default_rng(0).integers(
        -7, 8, (3, 5, 16)).astype(np.int8))
    assert tpa.pack_int4(wide).shape == (3, 5, 8)
    assert torch.equal(tpa.pack_int4(wide)[..., 2].to(torch.int32) >> 4,
                       wide[..., 10].to(torch.int32))
    assert torch.equal(tpa.unpack_int4(tpa.pack_int4(wide)), wide)
    assert tpa.pool_bits(tpa.pack_int4(wide), object(), 16) == 4
    assert tpa.pool_bits(wide, object(), 16) == 8
    assert tpa.pool_bits(wide, None, 16) == 0


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("fresh_in_pages", [True, False])
def test_int4_decode_plain_matches_pallas(T, fresh_in_pages):
    k, v, ks, vs = _codes(seed=T)
    rng = np.random.default_rng(10 + T)
    B = len(LENGTHS)
    q = rng.standard_normal((B, T, HQ, HD)).astype(np.float32)
    kn = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    pt = PAGE_TABLE.copy()
    if fresh_in_pages:
        pt[2, 0] = 13  # row 2's fresh tokens are stored in page 13
    fresh = (None, None) if fresh_in_pages else (kn, vn)
    want, want_lse = jpa.paged_decode_attention(
        jnp.asarray(q), *(None if x is None else jnp.asarray(x)
                          for x in fresh), *_jpool(k, v), jnp.asarray(pt),
        jnp.asarray(LENGTHS), jnp.int32(1), interpret=True,
        fresh_in_pages=fresh_in_pages, return_lse=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got, got_lse = tpa.paged_decode_attention(
        torch.from_numpy(q), *(None if x is None else torch.from_numpy(x)
                               for x in fresh), *_tpool(k, v),
        torch.from_numpy(pt), torch.from_numpy(LENGTHS), 1,
        fresh_in_pages=fresh_in_pages, return_lse=True,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)
    assert got.shape == (B, T, HQ, HD) and got_lse.shape == (B, HQ, T)


def test_int4_store_plain_matches_pallas():
    """The fresh token lands, quantized with qmax 7 and packed, at slot
    lengths % ps of the row's current page (row 2's page is unallocated: no
    write): values and scales equal the Pallas store's bit for bit."""
    k, v, ks, vs = _codes(seed=5)
    rng = np.random.default_rng(6)
    kn = (rng.standard_normal((3, 1, HKV, HD)) * 2).astype(np.float32)
    vn = (rng.standard_normal((3, 1, HKV, HD)) * 2).astype(np.float32)
    kn[0, 0, 1] = 0.0  # an all-zero head quantizes with scale 1
    pt = PAGE_TABLE.copy()
    pt[1, 4] = 12      # row 1 writes past its pages: clamped to entry 4
    lengths = np.array([19, 40, 0], np.int32)
    want = jpa.store_fresh_token(
        jnp.asarray(kn), jnp.asarray(vn), *_jpool(k, v), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.int32(1), interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tk, tv = _tpool(k, v)
    before = tk.clone()
    got = tpa.store_fresh_token(
        torch.from_numpy(kn), torch.from_numpy(vn), tk, tv,
        torch.from_numpy(pt), torch.from_numpy(lengths), 1,
        k_scales=torch.from_numpy(ks.copy()),
        v_scales=torch.from_numpy(vs.copy()))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(tpa.unpack_int4(g).numpy(),
                                      np.asarray(w.astype(jnp.int8)))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    changed = (got[0] != before)
    assert changed[1].sum() > 0 and changed[0].sum() == 0
    assert got[0].shape[-1] == HD // 2


def test_int4_prefill_plain_matches_pallas():
    k, v, ks, vs = _codes(seed=7)
    S = 20
    q = np.random.default_rng(8).standard_normal(
        (3, S, HQ, HD)).astype(np.float32)
    want, want_lse = jpa.paged_prefill_attention(
        jnp.asarray(q), *_jpool(k, v), jnp.asarray(PAGE_TABLE),
        jnp.asarray(LENGTHS), jnp.int32(1), interpret=True,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got, got_lse = tpa.paged_prefill_attention(
        torch.from_numpy(q), *_tpool(k, v), torch.from_numpy(PAGE_TABLE),
        torch.from_numpy(LENGTHS), 1, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)
    assert np.all(got_lse.numpy()[2] == np.float32(tpa.NEG_INF))
    assert np.all(got.numpy()[2] == 0)


def test_int4_prefill_bf16_rounding_matches_pallas():
    """bf16 queries over an int4 pool: the plain prefill converts codes
    (exact in bf16), scales the fp32 scores and rounds the weights times
    the v scale to bf16, as the tensor-core kernel does; against the
    Pallas kernel in interpret mode (fp32 weights) out within 1e-2 and lse
    within 2e-5, as in test_torch_paged.py."""
    k, v, ks, vs = _codes(seed=17)
    q = np.random.default_rng(18).standard_normal(
        (3, 20, HQ, HD)).astype(np.float32)
    want, want_lse = jpa.paged_prefill_attention(
        jnp.asarray(q).astype(jnp.bfloat16), *_jpool(k, v),
        jnp.asarray(PAGE_TABLE), jnp.asarray(LENGTHS), jnp.int32(1),
        interpret=True, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got, got_lse = tpa.paged_prefill_attention(
        torch.from_numpy(q).to(torch.bfloat16), *_tpool(k, v),
        torch.from_numpy(PAGE_TABLE), torch.from_numpy(LENGTHS), 1,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=2e-5)
    assert np.all(got.float().numpy()[2] == 0)


# --------------------------------------------------------------------- pool


def _cfg_llm(layers=2):
    return LLMConfig(vocab_size=100, hidden_size=HQ * HD,
                     intermediate_size=64, num_hidden_layers=layers,
                     num_attention_heads=HQ, num_key_value_heads=HKV)


def _same_pool(tc, jc):
    back = jax_paged_cache(tc)
    for n in ("k_pages", "v_pages", "page_table", "lengths", "next_page",
              "k_scales", "v_scales"):
        a, b = getattr(back, n), getattr(jc, n)
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(jnp.float32)),
                                      err_msg=n)


def test_int4_pool_takes_half_the_int8_bytes():
    cfg = port_config(_cfg_llm())
    c8 = tpk.PagedKVCache.zeros(cfg, 2, 16, 4, 8, kv_dtype="int8")
    c4 = tpk.PagedKVCache.zeros(cfg, 2, 16, 4, 8, kv_dtype="int4")
    assert c4.quantized and c4.kv_bits == 4 and c8.kv_bits == 8
    assert c4.k_pages.dtype == torch.int8
    assert c4.k_pages.shape == c8.k_pages.shape[:-1] + (HD // 2,)
    nbytes = lambda t: t.numel() * t.element_size()
    assert 2 * nbytes(c4.k_pages) == nbytes(c8.k_pages)
    assert c4.k_scales.shape == c8.k_scales.shape
    assert c4.page_size == 4 and c4.max_pages_per_row == 8


def test_int4_allocate_and_write_match_jax():
    """Allocation over three steps and both write paths (T > 1 with
    valid_t, T == 1) leave identical tables, pools and gathers."""
    cfg = _cfg_llm(layers=3)
    rng = np.random.default_rng(2)
    B = 2
    jc = jpk.PagedKVCache.zeros(cfg, B, 16, 4, 8, dtype=jnp.float32,
                                kv_dtype="int4")
    tc = tpk.PagedKVCache.zeros(port_config(cfg), B, 16, 4, 8,
                                dtype=torch.float32, kv_dtype="int4")
    for new, T in [(np.array([9, 5]), 9), (np.array([1, 1]), 1),
                   (np.array([3, 6]), 6)]:
        kn = rng.standard_normal((3, B, T, HKV, HD)).astype(np.float32)
        vn = rng.standard_normal((3, B, T, HKV, HD)).astype(np.float32)
        new32 = new.astype(np.int32)
        jc = jpk.allocate_rows(jc, jnp.asarray(new32))
        tc = tpk.allocate_rows(tc, torch.from_numpy(new32))
        vt = None if T == 1 else new32
        jc = jpk.write_all_layers(jc, jnp.asarray(kn), jnp.asarray(vn),
                                  valid_t=None if vt is None
                                  else jnp.asarray(vt))
        tc = tpk.write_all_layers(tc, torch.from_numpy(kn),
                                  torch.from_numpy(vn),
                                  valid_t=None if vt is None
                                  else torch.from_numpy(vt))
        jc = jpk.advance_lengths(jc, jnp.asarray(new32))
        tc = tpk.advance_lengths(tc, torch.from_numpy(new32))
    _same_pool(tc, jc)
    for layer in range(3):
        for a, b in zip(tpk.gather_row_kv(tc, layer),
                        jpk.gather_row_kv(jc, layer)):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    kn = rng.standard_normal((B, 2, HKV, HD)).astype(np.float32)
    jc = jpk.write_tokens(jc, 1, jnp.asarray(kn), jnp.asarray(kn))
    tc = tpk.write_tokens(tc, 1, torch.from_numpy(kn), torch.from_numpy(kn))
    _same_pool(tc, jc)


@pytest.mark.parametrize("kv", [None, "int8", "int4"])
def test_paged_cache_crosses_between_the_packages(kv):
    """torch_parity's helpers carry a pool from JAX to the port and back
    without changing a value, in every pool type."""
    cfg = _cfg_llm()
    rng = np.random.default_rng(3)
    jc = jpk.PagedKVCache.zeros(cfg, 2, 10, 4, 4, dtype=jnp.float32,
                                kv_dtype=kv)
    jc = jpk.allocate_rows(jc, jnp.asarray([7, 3], jnp.int32))
    kn = rng.standard_normal((2, 2, 7, HKV, HD)).astype(np.float32)
    jc = jpk.write_all_layers(jc, jnp.asarray(kn), jnp.asarray(-kn),
                              valid_t=jnp.asarray([7, 3], jnp.int32))
    tc = port_paged_cache(jc)
    assert tc.quantized == (kv is not None)
    assert tc.kv_bits == (4 if kv == "int4" else 8)
    assert tc.k_pages.shape[-1] == (HD // 2 if kv == "int4" else HD)
    _same_pool(tc, jc) if kv else np.testing.assert_array_equal(
        tc.k_pages.numpy(), np.asarray(jc.k_pages))
    for a, b in zip(tpk.gather_row_kv(tc, 1), jpk.gather_row_kv(jc, 1)):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


# -------------------------------------------------------------------- model

IMG = 291


def _vlm_cfg(vocab=300):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=64, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=HQ,
                      num_key_value_heads=HKV),
        rope_pos_id_stride=2)


def _sharpen(params):
    """Scale the wqkv kernel so that scores are not near uniform and the
    greedy tokens depend on the positions and the cache."""
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    return {**params, "llm": {**params["llm"], "layers": layers}}


@pytest.fixture(scope="module")
def models():
    cfg = _vlm_cfg()
    params = _sharpen(jax_init(jax.random.PRNGKey(0), cfg))
    return cfg, params, from_jax_params(jax.tree.map(np.asarray, params),
                                        port_config(cfg))


@pytest.mark.parametrize("prompt", [13, 24])
def test_int4_llm_forward_paged_matches_jax(models, prompt):
    """Prefill, then decode steps (store, then attend) crossing page
    boundaries over an int4 pool: logits within 2e-5 of their range at
    every step, the port's pool handed JAX's state after each step so both
    attend over equal codes."""
    cfg, params, model = models
    lc = cfg.llm
    total = prompt + 5
    ids = np.random.default_rng(prompt).integers(0, 300, (1, total))
    pos = np.arange(total, dtype=np.float32)[None] * 0.75
    jc = jpk.allocate_rows(
        jpk.PagedKVCache.zeros(lc, 1, 12, 4, 10, dtype=jnp.float32,
                               kv_dtype="int4"), jnp.asarray([prompt]))
    tc = port_paged_cache(jc)
    with torch.inference_mode():
        for t0, t1 in [(0, prompt)] + [(t, t + 1)
                                       for t in range(prompt, total)]:
            if t0:
                jc = jpk.allocate_rows(jc, jnp.asarray([1]))
                tc = tpk.allocate_rows(tc, torch.tensor([1]))
            jl, jc = jax_llm_forward(
                params["llm"], lc, input_ids=jnp.asarray(ids[:, t0:t1]),
                rope_pos_ids=jnp.asarray(pos[:, t0:t1]), paged_cache=jc,
                attn_impl="jnp")
            tl, tc = internlm2.llm_forward(
                model.llm, port_config(lc),
                input_ids=torch.from_numpy(ids[:, t0:t1]),
                rope_pos_ids=torch.from_numpy(pos[:, t0:t1]), paged_cache=tc)
            ref = np.asarray(jl)
            np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                                       atol=TOL * np.abs(ref).max(),
                                       err_msg=f"step {t0}")
            # a value on a rounding tie may quantize one code apart
            back = jax_paged_cache(tc)
            differ = np.count_nonzero(
                np.asarray(back.k_pages.astype(jnp.int8))
                != np.asarray(jc.k_pages.astype(jnp.int8)))
            assert differ <= 1e-3 * back.k_pages.size
            jc = jc._replace(lengths=jnp.asarray([t1], jnp.int32))
            tc = port_paged_cache(jc)


def test_int4_chunked_prefill_matches_jax(models):
    cfg, params, model = models
    lc = cfg.llm
    splits = (25, 35)
    ids = np.random.default_rng(1).integers(0, 300, (1, sum(splits)))
    pos = np.arange(sum(splits), dtype=np.float32)[None]
    jc = jpk.PagedKVCache.zeros(lc, 1, 32, 8, 12, dtype=jnp.float32,
                                kv_dtype="int4")
    tc = port_paged_cache(jc)
    off = 0
    for n in splits:
        jl, jc = jax_chunked(params["llm"], lc, jc,
                             input_ids=jnp.asarray(ids[:, off:off + n]),
                             rope_pos_ids=jnp.asarray(pos[:, off:off + n]),
                             attn_impl="jnp")
        tl, tc = chunked_prefill(model.llm, port_config(lc), tc,
                                 input_ids=torch.from_numpy(
                                     ids[:, off:off + n]),
                                 rope_pos_ids=torch.from_numpy(
                                     pos[:, off:off + n]))
        ref = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(),
                                   err_msg=f"chunk at {off}")
        assert int(tc.lengths[0]) == int(jc.lengths[0])
        np.testing.assert_allclose(tc.k_scales.numpy(),
                                   np.asarray(jc.k_scales), rtol=1e-5)
        tc = port_paged_cache(jc)
        off += n


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


@pytest.mark.parametrize("page_size", [4, 8])
def test_int4_paged_generate_matches_jax(models, page_size):
    """A ragged batch decodes through an int4 pool: greedy tokens, steps
    and lengths identical to JAX's paged generate with kv_dtype='int4'."""
    cfg, params, model = models
    ids, plen, pos, pixels, flags = _batch(cfg)
    gc = dict(max_new_tokens=7, eos_token_ids=(7,))
    paged = dict(cache_mode="paged", page_size=page_size, kv_dtype="int4")
    jt, jn, jl = jax_generate(
        params, cfg, JaxGenerationConfig(**gc), jnp.asarray(ids),
        jnp.asarray(plen), jnp.asarray(pos), jnp.asarray(pixels),
        jnp.asarray(flags), IMG, attn_impl="jnp", **paged)
    tt, tn, tl = generate(
        model, port_config(cfg), GenerationConfig(**gc),
        torch.from_numpy(ids), torch.from_numpy(plen), torch.from_numpy(pos),
        torch.from_numpy(pixels), torch.from_numpy(flags), IMG, **paged)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tn == int(jn)


@pytest.fixture(scope="module")
def chats():
    """(JAX ChatModel, port ChatModel), both paged with an int4 pool of
    8-token pages, over the same weights."""
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
    kw = dict(cache_mode="paged", page_size=8, kv_dtype="int4")
    return (JaxChatModel(params, cfg, tok, attn_impl="jnp", **kw),
            ChatModel(model, pcfg, tok, **kw))


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), dtype=np.uint8))


def test_int4_chat_matches_jax(chats):
    jchat, tchat = chats
    pixels, n = tchat.load_pixels(_image(0, 80, 120), max_num=4)
    got = tchat.chat(pixels, "What is this?", GenerationConfig(
        max_new_tokens=8), return_history=True, num_patches_list=[n])
    want = jchat.chat(pixels, "What is this?", JaxGenerationConfig(
        max_new_tokens=8), return_history=True, num_patches_list=[n])
    assert got == want
    qs = ["Say A.", "Count to three, please."]
    assert tchat.batch_chat(None, qs, GenerationConfig(max_new_tokens=6)) \
        == jchat.batch_chat(None, qs, JaxGenerationConfig(max_new_tokens=6))


def test_int4_session_three_turns_match_jax(chats):
    """Turn 1 prefills into an empty int4 pool, turns 2 and 3 prefill only
    their suffix over it (the paged prefill path): every reply equals the
    JAX session's."""
    jchat, tchat = chats
    kw = dict(max_len=2048, page_size=8, chunk_multiple=64, kv_dtype="int4")
    jsess, tsess = JaxChatSession(jchat, **kw), ChatSession(tchat, **kw)
    assert tsess.cache.kv_bits == 4
    for img, q in [(_image(1, 64, 80), "One."), (_image(2, 80, 64), "Two."),
                   (None, "Three?")]:
        pv = None if img is None else tchat.load_pixels(img)[0]
        want = jsess.send(pv, q, JaxGenerationConfig(max_new_tokens=5))
        got = tsess.send(pv, q, GenerationConfig(max_new_tokens=5))
        assert got == want, q
    assert tsess.consumed == jsess.consumed > 0
    assert int(tsess.cache.lengths[0]) == int(jsess.cache.lengths[0])
