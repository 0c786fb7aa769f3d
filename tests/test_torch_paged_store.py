"""The store riding in the port's paged decode launch, against the JAX
package on the CPU.

``ops/paged_attention.paged_decode_attention(..., store=True)`` writes the
fresh k/v into the pool in the same call that attends: at T = 1 with the
token in the pages it stores first (JAX: ``store_fresh_token`` then
``paged_decode_attention(fresh_in_pages=True)``, the Pallas kernels in
interpret mode), and folding 2-16 tokens it attends them unquantized and
then stores a prefix of ``store_n`` of them (JAX:
``paged_kv.write_all_layers``). On the CPU the plain versions run; the CUDA
kernel is held to them on the card by ``chip_smoke.py``.

Tolerances: pool values and scales exactly equal (fp32, bf16, int8 and
packed int4 pools); attention outputs and lse as in test_torch_paged.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.infer import paged_kv as jpk
from v2pe_tpu.ops import paged_attention as jpa
from v2pe_tpu_torch.infer import paged_kv as tpk
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.ops import paged_attention as tpa

from .test_torch_paged import (HD, HKV, HQ, L, NP, PAGE_TABLE, PS, TOL,
                               _cfg_llm)
from .torch_parity import port_config, port_paged_cache, to_numpy

KINDS = ["float32", "bfloat16", "int8", "int4"]


def _jax_pool(kind: str, seed: int):
    """A JAX pool of one kind: fp32 or bf16 values, int8 codes, or
    ``jnp.int4`` codes, with fp32 scales for the last two."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, NP, PS, HD)
    if kind in ("int8", "int4"):
        top = 127 if kind == "int8" else 7
        k, v = (jnp.asarray(rng.integers(-top, top + 1, shape).astype(
            np.int8)) for _ in range(2))
        if kind == "int4":
            k, v = k.astype(jnp.int4), v.astype(jnp.int4)
        ks, vs = (jnp.asarray(rng.uniform(0.005, 0.4, (L, HKV, NP, 1, PS))
                              .astype(np.float32)) for _ in range(2))
        return k, v, ks, vs
    k, v = (jnp.asarray(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    if kind == "bfloat16":
        k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    return k, v, None, None


def _caches(kind, page_table, lengths, seed):
    """The same pool as a JAX PagedKVCache and as the port's."""
    k, v, ks, vs = _jax_pool(kind, seed)
    jc = jpk.PagedKVCache(k, v, jnp.asarray(page_table),
                          jnp.asarray(lengths), jnp.ones((1,), jnp.int32),
                          ks, vs)
    return jc, port_paged_cache(jc)


def _fresh(rng, shape, kind):
    """Fresh values in the queries' dtype: bf16 for a bf16 pool, else
    fp32 (a quantized pool quantizes fp32 values)."""
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    if kind == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _assert_pools_equal(tc, jc):
    """Values (int4 as the port's packed bytes) and scales bit for bit."""
    want = port_paged_cache(jc)
    names = ("k_pages", "v_pages") + (
        ("k_scales", "v_scales") if tc.quantized else ())
    for n in names:
        got, ref = getattr(tc, n), getattr(want, n)
        assert got.dtype == ref.dtype, n
        assert torch.equal(got, ref), n


@pytest.mark.parametrize("kind", KINDS)
def test_store_then_attend_matches_jax(kind):
    """T = 1: one call stores and attends the token as stored. Row 0
    writes slot 3 of entry 2, row 1 runs past its 40 slots and writes into
    its last entry (clamped), row 2's page is unallocated (no write; it
    attends nothing). Against JAX's store kernel then its decode kernel
    with the fresh token in the pages."""
    pt = PAGE_TABLE.copy()
    pt[1, 4] = 12
    lengths = np.array([19, 40, 0], np.int32)
    jc, tc = _caches(kind, pt, lengths, seed=5)
    rng = np.random.default_rng(6)
    jq, tq = _fresh(rng, (3, 1, HQ, HD), kind)
    jk, tk = _fresh(rng, (3, 1, HKV, HD), kind)
    jv, tv = _fresh(rng, (3, 1, HKV, HD), kind)
    jk = jk.at[0, 0, 1].set(0.0)  # an all-zero head quantizes with scale 1
    tk[0, 0, 1] = 0.0
    jscales = {} if jc.k_scales is None else dict(k_scales=jc.k_scales,
                                                  v_scales=jc.v_scales)
    stored = jpa.store_fresh_token(jk, jv, jc.k_pages, jc.v_pages,
                                   jc.page_table, jc.lengths, jnp.int32(1),
                                   interpret=True, **jscales)
    jc = jc._replace(k_pages=stored[0], v_pages=stored[1],
                     **(dict(k_scales=stored[2], v_scales=stored[3])
                        if len(stored) == 4 else {}))
    jscales = {} if jc.k_scales is None else dict(k_scales=jc.k_scales,
                                                  v_scales=jc.v_scales)
    want, want_lse = jpa.paged_decode_attention(
        jq, None, None, jc.k_pages, jc.v_pages, jc.page_table, jc.lengths,
        jnp.int32(1), interpret=True, fresh_in_pages=True, return_lse=True,
        **jscales)
    before = tc.k_pages.clone()
    got, got_lse = tpa.paged_decode_attention(
        tq, tk, tv, tc.k_pages, tc.v_pages, tc.page_table, tc.lengths, 1,
        fresh_in_pages=True, return_lse=True, store=True,
        k_scales=tc.k_scales, v_scales=tc.v_scales)
    _assert_pools_equal(tc, jc)
    changed = tc.k_pages != before
    assert changed[1].any() and not changed[0].any()
    tol = TOL.get(kind, TOL["int8"])
    np.testing.assert_allclose(to_numpy(got).astype(np.float64),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=tol, rtol=tol)
    assert np.all(got_lse.numpy()[2] == np.float32(tpa.NEG_INF))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [2, 5, 16])
def test_folded_store_matches_write_all_layers(T, kind):
    """2 <= T <= 16: the fresh tokens attended folded in, then the first
    ``store_n`` of each row stored; every layer's call leaves the pool
    JAX's ``write_all_layers`` leaves, for store_n None (all T), 0 and a
    prefix of each row (all, part, none). Row 0's tokens past slot 31 meet
    an unallocated entry (no write); rows 1-2 have room. The output equals
    a call without the store."""
    pt = PAGE_TABLE.copy()
    pt[1, 4], pt[2, :2] = 12, [13, 4]
    lengths = np.array([19, 22, 0], np.int32)
    rng = np.random.default_rng(T)
    jk, tk = _fresh(rng, (L, 3, T, HKV, HD), kind)
    jv, tv = _fresh(rng, (L, 3, T, HKV, HD), kind)
    _, tq = _fresh(rng, (3, T, HQ, HD), kind)
    for n in (None, [0, 0, 0], [T, T // 2, 0]):
        jc, tc = _caches(kind, pt, lengths, seed=T + 1)
        jc = jpk.write_all_layers(
            jc, jk, jv, valid_t=None if n is None else jnp.asarray(
                n, jnp.int32))
        store_n = None if n is None else torch.tensor(n, dtype=torch.int32)
        for li in range(L):
            pool = (tc.k_pages, tc.v_pages, tc.page_table, tc.lengths, li)
            scales = dict(k_scales=tc.k_scales, v_scales=tc.v_scales,
                          return_lse=True)
            plain = tpa.paged_decode_attention(tq, tk[li], tv[li], *pool,
                                               **scales)
            got = tpa.paged_decode_attention(tq, tk[li], tv[li], *pool,
                                             store=True, store_n=store_n,
                                             **scales)
            assert torch.equal(got[0], plain[0])
            assert torch.equal(got[1], plain[1])
        _assert_pools_equal(tc, jc)


def test_store_arguments_are_checked():
    """A store needs fresh k/v of the queries' shape and dtype, one token
    to store and then attend, and an int32 (B,) store_n."""
    jc, tc = _caches("float32", PAGE_TABLE, np.array([19, 27, 0], np.int32),
                     seed=1)
    q = torch.zeros(3, 2, HQ, HD)
    kv = torch.zeros(3, 2, HKV, HD)
    pool = (tc.k_pages, tc.v_pages, tc.page_table, tc.lengths, 0)
    with pytest.raises(ValueError, match="one fresh token"):
        tpa.paged_decode_attention(q, kv, kv, *pool, fresh_in_pages=True,
                                   store=True)
    with pytest.raises(ValueError, match="fresh k/v"):
        tpa.paged_decode_attention(q, None, None, *pool, store=True)
    with pytest.raises(ValueError, match="fresh k/v"):
        tpa.paged_decode_attention(q, kv.double(), kv, *pool, store=True)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_decode_attention(q, kv, kv, *pool, store=True,
                                   store_n=torch.zeros(3))


@pytest.mark.parametrize("S,seg", [(1, False), (5, False), (5, True),
                                   (16, True)])
def test_paged_decode_steps_launch_no_store(monkeypatch, S, seg):
    """The paged steps of llm_forward with S <= 16 tokens a row write the
    pool through the decode call alone: store_fresh_token, scatter_layers
    and token_slots (which reads the card) are not called, and the pool
    equals the one that store-then-attend (S == 1) or attend-then-scatter
    (S > 1) leaves."""
    cfg = port_config(_cfg_llm())
    torch.manual_seed(0)
    model = internlm2.InternLM2Model(cfg).eval()
    cache = tpk.PagedKVCache.zeros(cfg, 2, 16, PS, 6, dtype=torch.float32,
                                   kv_dtype="int8")
    cache = tpk.allocate_rows(cache, torch.tensor([19, 11], dtype=torch.int32))
    cache = tpk.advance_lengths(cache, torch.tensor([19, 11],
                                                    dtype=torch.int32))
    cache = tpk.allocate_rows(cache, torch.full((2,), S, dtype=torch.int32))
    ids = torch.randint(0, cfg.vocab_size, (2, S))
    segment_ids = None
    if seg:  # row 1 right-padded to S
        segment_ids = torch.ones((2, S), dtype=torch.int32)
        segment_ids[1, S - 2:] = 0
    ref_cache = tpk.PagedKVCache(**{f: getattr(cache, f).clone()
                                    if torch.is_tensor(getattr(cache, f))
                                    else getattr(cache, f)
                                    for f in cache.__dataclass_fields__})
    with torch.no_grad():
        ref, _ = _two_call_forward(model, cfg, ids, segment_ids, ref_cache)

    def refuse(*a, **k):
        raise AssertionError("a paged step of <= 16 tokens stored apart")

    monkeypatch.setattr(tpa, "store_fresh_token", refuse)
    monkeypatch.setattr(internlm2.paged_kv, "scatter_layers", refuse)
    monkeypatch.setattr(internlm2.paged_kv, "token_slots", refuse)
    with torch.no_grad():
        got, _ = internlm2.llm_forward(model, cfg, input_ids=ids,
                                       segment_ids=segment_ids,
                                       paged_cache=cache)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    for n in ("k_pages", "v_pages", "k_scales", "v_scales"):
        assert torch.equal(getattr(cache, n), getattr(ref_cache, n)), n


def _two_call_forward(model, cfg, ids, segment_ids, cache):
    """llm_forward as it was with a store apart: at S == 1 the store, then
    the decode with the token in the pages; at S > 1 the decode folding the
    fresh tokens, then their write by token_slots and scatter_layers."""
    S = ids.shape[1]

    def paged_attention(paged, q, k, v, seg, positions):
        c, li = paged.cache, paged.layer
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        pool = (c.k_pages, c.v_pages, c.page_table, c.lengths, li)
        sc = dict(k_scales=c.k_scales, v_scales=c.v_scales)
        if S == 1:
            tpa.store_fresh_token(k, v, *pool, **sc)
            return tpa.paged_decode_attention(q, None, None, *pool,
                                              fresh_in_pages=True, **sc)
        out = tpa.paged_decode_attention(q, k, v, *pool, **sc)
        tpk.scatter_layers(c, slice(li, li + 1), k[None], v[None],
                           tpk.token_slots(c, S, None if seg is None
                                           else seg != 0))
        return out

    own = internlm2._paged_attention
    internlm2._paged_attention = paged_attention
    try:
        return internlm2.llm_forward(model, cfg, input_ids=ids,
                                     segment_ids=segment_ids,
                                     paged_cache=cache)
    finally:
        internlm2._paged_attention = own
