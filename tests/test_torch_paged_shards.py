"""The sequence-sharded paged pool of the port against JAX's on the CPU.

JAX splits the pool's page axis over the mesh's ``seq`` axis (and its kv
heads over ``tensor``) and runs its eight shard functions under
``shard_map`` on the eight forced host devices of ``tests/conftest.py``,
the Pallas kernels in interpret mode. The port holds every shard in one
pool (one card) and runs the kernels' twins once a shard; JAX's ``tensor``
split is the port's kernels on each half of the heads. Also here: the
local page view, the round-robin allocation, the ``fresh_pages`` store
against JAX's and a rank's own shard (``held``) merged with the others;
the chunked prefill and a verify step across a page boundary are in
``tests/test_torch_paged_shards_prefill.py``.

Tolerances: fp32 outputs 2e-5 (2e-5 is tests/test_chunked_prefill.py's);
pools, tables, allocation and quantized codes exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from v2pe_tpu.core.config import LLMConfig
from v2pe_tpu.infer import paged_kv as jpk
from v2pe_tpu.ops import paged_attention as jpa
from v2pe_tpu_torch.infer import paged_kv as tpk
from v2pe_tpu_torch.ops import paged_attention as tpa

from .torch_parity import port_config, port_paged_cache, to_numpy

TOL = 2e-5
N_SEQ, NP, PS, MP = 4, 32, 8, 8
LENGTHS = [23, 11, 0]   # row 2 holds no page: every shard's view is dead


def _cfg():
    return LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=4)


def _jax_cache(cfg, lengths, seed, kv_dtype=None, n_shards=N_SEQ):
    rng = np.random.RandomState(seed)
    lens = jnp.asarray(lengths, jnp.int32)
    cache = jpk.PagedKVCache.zeros(cfg, batch=len(lengths), n_pages=NP,
                                   page_size=PS, max_pages_per_row=MP,
                                   dtype=jnp.float32, n_shards=n_shards,
                                   kv_dtype=kv_dtype)
    cache = jpk.allocate_rows(cache, lens)
    S = max(lengths)
    shape = (cfg.num_hidden_layers, len(lengths), S, cfg.num_key_value_heads,
             cfg.head_dim)
    k, v = (jnp.asarray(rng.randn(*shape).astype(np.float32))
            for _ in range(2))
    cache = jpk.write_all_layers(cache, k, v, valid_t=lens)
    return cache._replace(lengths=lens)


def _mesh(tensor):
    return Mesh(np.array(jax.devices()[:N_SEQ * tensor]).reshape(N_SEQ,
                                                                 tensor),
                ("seq", "tensor"))


def _fresh(cfg, B, T, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, cfg.num_attention_heads, cfg.head_dim)
    k = rng.randn(B, T, cfg.num_key_value_heads, cfg.head_dim)
    v = rng.randn(B, T, cfg.num_key_value_heads, cfg.head_dim)
    return [x.astype(np.float32) for x in (q, k, v)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _halves(tensor, Hq, Hkv):
    """The head ranges of each tensor rank: (q heads, kv heads)."""
    gq, gk = Hq // tensor, Hkv // tensor
    return [(slice(i * gq, (i + 1) * gq), slice(i * gk, (i + 1) * gk))
            for i in range(tensor)]


def _pool_of(cache, kh):
    """A tensor rank's contiguous copy of the port pool's kv heads."""
    pick = lambda x: None if x is None else x[:, kh].contiguous()  # noqa
    return [pick(x) for x in (cache.k_pages, cache.v_pages, cache.k_scales,
                              cache.v_scales)]


def _put_back(cache, kh, parts):
    for dst, src in zip((cache.k_pages, cache.v_pages, cache.k_scales,
                         cache.v_scales), parts):
        if dst is not None:
            dst[:, kh] = src


# ------------------------------------------------------- tables and views


def test_allocate_rows_round_robin_matches_jax():
    """Per-shard heads and round-robin placement, over ragged rounds, page
    for page as JAX's allocate_rows (tests/test_decode_mesh.py:115)."""
    cfg = _cfg()
    for n in (1, 4):
        j = jpk.PagedKVCache.zeros(cfg, batch=3, n_pages=64, page_size=PS,
                                   max_pages_per_row=12, n_shards=n,
                                   dtype=jnp.float32)
        t = tpk.PagedKVCache.zeros(port_config(cfg), 3, 64, PS, 12,
                                   dtype=torch.float32, n_shards=n)
        np.testing.assert_array_equal(to_numpy(t.next_page),
                                      np.asarray(j.next_page))
        for new in ([40, 24, 0], [1, 9, 17], [0, 0, 8], [30, 1, 2]):
            j = jpk.allocate_rows(j, jnp.asarray(new, jnp.int32))
            t = tpk.allocate_rows(t, torch.tensor(new, dtype=torch.int32))
            j = j._replace(lengths=j.lengths + jnp.asarray(new, jnp.int32))
            t = tpk.advance_lengths(t, torch.tensor(new, dtype=torch.int32))
            np.testing.assert_array_equal(to_numpy(t.page_table),
                                          np.asarray(j.page_table))
            np.testing.assert_array_equal(to_numpy(t.next_page),
                                          np.asarray(j.next_page))
        NPl = 64 // n
        pt = to_numpy(t.page_table)
        live = pt >= 0
        assert ((pt // NPl)[live] == (np.nonzero(live)[1] % n)).all()
        assert (pt[live] % NPl != 0).all()  # no shard's null page


def test_local_page_view_matches_jax(jax8):
    """Compacted local tables and their table slots, shard by shard, as
    JAX's _local_page_view inside shard_map."""
    cfg = _cfg()
    cache = _jax_cache(cfg, LENGTHS + [64], 0)
    pt = cache.page_table

    def body(table):
        pt_l, slots, _ = jpa._local_page_view(table, "seq", N_SEQ, NP)
        return pt_l[None], slots[None]

    mesh = Mesh(np.array(jax.devices()[:N_SEQ]), ("seq",))
    ids, slots = jax.shard_map(body, mesh=mesh, in_specs=P(None, None),
                               out_specs=(P("seq"), P("seq")),
                               check_vma=False)(pt)
    for d in range(N_SEQ):
        got_ids, got_slots = tpa.local_page_view(_t(pt), d, N_SEQ, NP)
        np.testing.assert_array_equal(to_numpy(got_ids), np.asarray(ids[d]))
        np.testing.assert_array_equal(to_numpy(got_slots),
                                      np.asarray(slots[d]))
    # one card's views: global ids; a rank's view (held): local ids
    views = tpa.shard_views(_t(pt), _t(cache.lengths), N_SEQ, NP, PS)
    held = [tpa.shard_views(_t(pt), _t(cache.lengths), N_SEQ, NP, PS,
                            held=d)[0] for d in range(N_SEQ)]
    for d, (one, own) in enumerate(zip(views, held)):
        loc = to_numpy(own.page_table)
        np.testing.assert_array_equal(loc, np.asarray(ids[d]))
        np.testing.assert_array_equal(
            to_numpy(one.page_table), np.where(loc >= 0, loc + d * NP //
                                               N_SEQ, -1))
        np.testing.assert_array_equal(
            to_numpy(own.slot_base), np.where(np.asarray(slots[d]) >= 0,
                                              np.asarray(slots[d]) * PS, -1))


# ----------------------------------------------------- the fresh_pages hook


@pytest.mark.parametrize("kv", [None, "int8"])
def test_fresh_pages_store_twin_matches_pallas(kv):
    """store_fresh_token(fresh_pages=...) with -1 on some rows: the twin,
    standalone and riding in the decode twin, equals JAX's Pallas store
    (interpret) bit for bit."""
    cfg = _cfg()
    cache = _jax_cache(cfg, [23, 11, 5], 1, kv_dtype=kv, n_shards=1)
    _, k, v = _fresh(cfg, 3, 1, 2)
    fp = np.array([3, -1, 7], np.int32)
    scales = dict(k_scales=cache.k_scales, v_scales=cache.v_scales)
    ref = jpa.store_fresh_token(jnp.asarray(k), jnp.asarray(v), cache.k_pages,
                                cache.v_pages, cache.page_table,
                                cache.lengths, jnp.int32(1), interpret=True,
                                fresh_pages=jnp.asarray(fp), **scales)
    for riding in (False, True):
        t = port_paged_cache(cache)
        pool = (t.k_pages, t.v_pages)
        tables = (t.page_table, t.lengths, 1)
        tsc = dict(k_scales=t.k_scales, v_scales=t.v_scales)
        if riding:
            q = _t(_fresh(cfg, 3, 1, 3)[0])
            tpa.paged_decode_attention(q, _t(k), _t(v), *pool, *tables,
                                       fresh_in_pages=True, store=True,
                                       fresh_pages=_t(fp), **tsc)
        else:
            tpa.store_fresh_token(_t(k), _t(v), *pool, *tables,
                                  fresh_pages=_t(fp), **tsc)
        got = [t.k_pages, t.v_pages] + ([t.k_scales, t.v_scales] if kv
                                        else [])
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    with pytest.raises(ValueError):  # a folding store has no such hook
        tpa.paged_decode_attention(
            _t(_fresh(cfg, 3, 2, 4)[0]), *[_t(x) for x in
                                           _fresh(cfg, 3, 2, 4)[1:]],
            *pool, *tables, store=True, fresh_pages=_t(fp), **tsc)


# ------------------------------------------------ the shard functions


@pytest.mark.parametrize("tensor,kv", [(1, "int8"), (2, None)])
def test_seq_sharded_store_then_decode_matches_jax(jax8, tensor, kv):
    """T = 1: JAX's seq_sharded_store_fresh_token then its decode with the
    fresh token in the pages, at seq 4 x tensor 1 (int8 pool) and 2 (fp32
    pool), against the port's
    store riding in each shard's decode launch (pools equal, outputs within
    2e-5); the port's standalone sharded store writes the same pool."""
    cfg = _cfg()
    cache = _jax_cache(cfg, LENGTHS, 2, kv_dtype=kv)
    q, k, v = _fresh(cfg, len(LENGTHS), 1, 5)
    mesh = _mesh(tensor)
    sc = dict(k_scales=cache.k_scales, v_scales=cache.v_scales)
    stored = jpa.seq_sharded_store_fresh_token(
        mesh, "seq", "tensor", jnp.asarray(k), jnp.asarray(v), cache.k_pages,
        cache.v_pages, cache.page_table, cache.lengths, jnp.int32(1),
        interpret=True, **sc)
    jsc = dict(k_scales=stored[2], v_scales=stored[3]) if kv else {}
    ref = jpa.seq_sharded_paged_decode_attention(
        mesh, "seq", "tensor", jnp.asarray(q), None, None, stored[0],
        stored[1], cache.page_table, cache.lengths, jnp.int32(1),
        interpret=True, fresh_in_pages=True, **jsc)

    for standalone in (False, True):
        t = port_paged_cache(cache)
        views = tpk.shard_views(t, fresh=True)
        out = torch.empty(q.shape)
        for qh, kh in _halves(tensor, cfg.num_attention_heads,
                              cfg.num_key_value_heads):
            kp, vp, ks, vs = _pool_of(t, kh)
            kn, vn = _t(k)[:, :, kh].contiguous(), _t(v)[:, :, kh].contiguous()
            if standalone:
                tpa.seq_sharded_store_fresh_token(
                    kn, vn, kp, vp, views, t.lengths, 1, k_scales=ks,
                    v_scales=vs)
            else:
                out[:, :, qh] = tpa.seq_sharded_paged_decode_attention(
                    _t(q)[:, :, qh].contiguous(), kn, vn, kp, vp, views,
                    t.lengths, 1, fresh_in_pages=True, store=True,
                    k_scales=ks, v_scales=vs)
            _put_back(t, kh, (kp, vp, ks, vs))
        got = [t.k_pages, t.v_pages] + ([t.k_scales, t.v_scales] if kv
                                        else [])
        for a, b in zip(got, stored):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
        if not standalone:
            np.testing.assert_allclose(to_numpy(out), np.asarray(ref),
                                       atol=TOL, rtol=TOL)
            assert not to_numpy(out)[2].any()  # row 2 attends nothing


@pytest.mark.parametrize("tensor", [1, 2])
def test_seq_sharded_fold_decode_matches_jax(jax8, tensor):
    """T = 4 folded fresh tokens (counted on shard 0 alone) against JAX's
    seq_sharded_paged_decode_attention; a rank's own shard (``held``, its
    pool holding only its pages) merged with the others gives the same."""
    cfg = _cfg()
    cache = _jax_cache(cfg, LENGTHS, 3)
    q, k, v = _fresh(cfg, len(LENGTHS), 4, 6)
    ref = jpa.seq_sharded_paged_decode_attention(
        _mesh(tensor), "seq", "tensor", jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), cache.k_pages, cache.v_pages, cache.page_table,
        cache.lengths, jnp.int32(0), interpret=True)
    t = port_paged_cache(cache)
    views = tpk.shard_views(t)
    out = torch.empty(q.shape)
    for qh, kh in _halves(tensor, cfg.num_attention_heads,
                          cfg.num_key_value_heads):
        kp, vp, _, _ = _pool_of(t, kh)
        out[:, :, qh] = tpa.seq_sharded_paged_decode_attention(
            _t(q)[:, :, qh].contiguous(), _t(k)[:, :, kh].contiguous(),
            _t(v)[:, :, kh].contiguous(), kp, vp, views, t.lengths, 0)
    np.testing.assert_allclose(to_numpy(out), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    NPl = NP // N_SEQ
    parts = []
    for d in range(N_SEQ):
        view, = tpa.shard_views(t.page_table, t.lengths, N_SEQ, NP, PS,
                                held=d)
        own = [x[:, :, d * NPl:(d + 1) * NPl].contiguous()
               for x in (t.k_pages, t.v_pages)]
        part = tpa.paged_decode_attention(
            _t(q), _t(k), _t(v), *own, view.page_table, t.lengths, 0,
            slot_base=view.slot_base, fold_fresh=int(d == 0),
            return_lse=True)
        if d > 0:  # rows with no page on this shard: out 0, lse -1e30
            assert (part[1][2] == tpa.NEG_INF).all()
            assert not part[0][2].any()
        parts.append(part)
    np.testing.assert_allclose(to_numpy(tpa.merge_shards(parts)),
                               np.asarray(ref), atol=TOL, rtol=TOL)
