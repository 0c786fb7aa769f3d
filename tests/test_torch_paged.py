"""Parity of the port's paged-KV slice with the JAX package on the CPU.

The paged kernels' plain twins (v2pe_tpu_torch/ops/paged_attention.py)
against the Pallas kernels run in interpret mode, as the JAX package's own
tests run them; the pool helpers of infer/paged_kv.py; the paged branches of
llm_forward; chunked prefill; and paged generate/stream_generate, whose
greedy tokens must be identical. The CUDA kernels themselves are held to the
twins on the card by chip_smoke.py.

Tolerances: fp32 outputs (fp32 queries over fp32 or int8 pools) 2e-5;
bf16 outputs 1e-2, one bf16 rounding of values of magnitude up to ~2;
quantization, allocation and pool writes exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer import paged_kv as jpk
from v2pe_tpu.infer.chunked_prefill import chunked_prefill as jax_chunked
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.generate import generate as jax_generate
from v2pe_tpu.infer.streaming import stream_generate as jax_stream
from v2pe_tpu.models.internlm2 import llm_forward as jax_llm_forward
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.ops import paged_attention as jpa
from v2pe_tpu_torch.infer import paged_kv as tpk
from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
from v2pe_tpu_torch.infer.streaming import stream_generate
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.ops import paged_attention as tpa

from .torch_parity import port_config, run_parity, to_numpy

TOL = {"float32": 2e-5, "int8": 2e-5, "bfloat16": 1e-2}
L, HQ, HKV, HD, NP, PS = 2, 4, 2, 16, 14, 8
# three rows over 5 table entries of 8 slots: ragged lengths, a dead (-1)
# entry inside row 1's range, and row 2 with no pages at all
PAGE_TABLE = np.array([[3, 7, 1, 9, -1], [2, -1, 5, 11, -1],
                       [-1, -1, -1, -1, -1]], np.int32)
LENGTHS = np.array([19, 27, 0], np.int32)


def _pool(kv: str, seed: int = 0):
    """numpy pool of one kind: fp32 values (cast to bf16 by the callers),
    or int8 values with fp32 scales (None otherwise)."""
    rng = np.random.default_rng(seed)
    shape = (L, HKV, NP, PS, HD)
    if kv == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, (L, HKV, NP, 1, PS))
                  .astype(np.float32) for _ in range(2))
        return k, v, ks, vs
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return k, v, None, None


def _jcast(x, kv):
    return x.astype(jnp.bfloat16) if kv == "bfloat16" else x


def _tcast(x, kv):
    return x.to(torch.bfloat16) if kv == "bfloat16" else x


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("fresh_in_pages", [True, False])
def test_decode_twin_matches_pallas(kv, T, fresh_in_pages):
    k, v, ks, vs = _pool(kv, seed=T)
    rng = np.random.default_rng(10 + T)
    B = len(LENGTHS)
    q = rng.standard_normal((B, T, HQ, HD)).astype(np.float32)
    kn = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    vn = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    pt = PAGE_TABLE.copy()
    if fresh_in_pages:
        pt[2, 0] = 13  # row 2's fresh tokens are stored in page 13
    scales = () if ks is None else (ks, vs)

    def jfn(q, kn, vn, k, v, pt, ln, *sc):
        kw = {} if not sc else dict(k_scales=sc[0], v_scales=sc[1])
        fresh = (None, None) if fresh_in_pages else (_jcast(kn, kv),
                                                     _jcast(vn, kv))
        return jpa.paged_decode_attention(
            _jcast(q, kv), *fresh, _jcast(k, kv), _jcast(v, kv), pt, ln,
            jnp.int32(1), interpret=True, fresh_in_pages=fresh_in_pages,
            return_lse=True, **kw)

    def tfn(q, kn, vn, k, v, pt, ln, *sc):
        kw = {} if not sc else dict(k_scales=sc[0], v_scales=sc[1])
        fresh = (None, None) if fresh_in_pages else (_tcast(kn, kv),
                                                     _tcast(vn, kv))
        return tpa.paged_decode_attention(
            _tcast(q, kv), *fresh, _tcast(k, kv), _tcast(v, kv), pt, ln, 1,
            fresh_in_pages=fresh_in_pages, return_lse=True, **kw)

    p = run_parity(jfn, tfn, q, kn, vn, k, v, pt, LENGTHS, *scales)
    tol = TOL[kv]
    p.assert_close(atol=tol, rtol=tol)
    assert p.torch[0].shape == (B, T, HQ, HD)
    assert p.torch[1].shape == (B, HQ, T)


def test_decode_dead_entries_and_rows_without_keys():
    """A shard-local page view: slot_base -1 marks dead entries, the fresh
    tokens are not folded (fold_fresh=0), and row 2 has nothing to attend:
    out 0, lse -1e30."""
    k, v, _, _ = _pool("float32", seed=3)
    rng = np.random.default_rng(4)
    B, T = 3, 2
    q = rng.standard_normal((B, T, HQ, HD)).astype(np.float32)
    kn = rng.standard_normal((B, T, HKV, HD)).astype(np.float32)
    sb = np.where(PAGE_TABLE >= 0, np.arange(5) * PS, -1).astype(np.int32)
    sb[0, 1] = -1  # another shard owns row 0's second page

    def run(lib, mod, layer, fold):
        def fn(q, kn, k, v, pt, ln, sb):
            return mod.paged_decode_attention(
                q, kn, kn, k, v, pt, ln, layer, slot_base=sb,
                fold_fresh=fold, return_lse=True,
                **(dict(interpret=True) if lib is jnp else {}))
        return fn

    p = run_parity(run(jnp, jpa, jnp.int32(0), jnp.zeros((), jnp.int32)),
                   run(torch, tpa, 0, 0), q, kn, k, v, PAGE_TABLE, LENGTHS,
                   sb)
    p.assert_close(atol=2e-5, rtol=2e-5)
    assert np.all(p.torch[0][2] == 0)
    assert np.all(p.torch[1][2] == np.float32(tpa.NEG_INF))


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_store_twin_matches_pallas(kv):
    """The fresh token lands at slot lengths % ps of the row's current page
    (row 2's page is unallocated: no write); int8 pools take the quantized
    values and scales bit for bit."""
    k, v, ks, vs = _pool(kv, seed=5)
    rng = np.random.default_rng(6)
    kn = (rng.standard_normal((3, 1, HKV, HD)) * 2).astype(np.float32)
    vn = (rng.standard_normal((3, 1, HKV, HD)) * 2).astype(np.float32)
    kn[0, 0, 1] = 0.0  # an all-zero head quantizes with scale 1
    # row 0 writes slot 3 of entry 2 (page 1), row 1 slot 0 of entry 4
    # after its pages run out (clamped to the last entry), row 2 nothing
    pt = PAGE_TABLE.copy()
    pt[1, 4] = 12
    lengths = np.array([19, 40, 0], np.int32)
    pool = (k.astype(np.float32), v.astype(np.float32)) if kv != "int8" \
        else (k, v, ks, vs)

    def jfn(kn, vn, pt, ln, *pool):
        kw = {} if len(pool) == 2 else dict(k_scales=pool[2],
                                            v_scales=pool[3])
        pages = [_jcast(x, kv) for x in pool[:2]]
        return jpa.store_fresh_token(_jcast(kn, kv), _jcast(vn, kv), *pages,
                                     pt, ln, jnp.int32(1), interpret=True,
                                     **kw)

    def tfn(kn, vn, pt, ln, *pool):
        kw = {} if len(pool) == 2 else dict(k_scales=pool[2],
                                            v_scales=pool[3])
        pages = [_tcast(x, kv) for x in pool[:2]]
        return tpa.store_fresh_token(_tcast(kn, kv), _tcast(vn, kv), *pages,
                                     pt, ln, 1, **kw)

    p = run_parity(jfn, tfn, kn, vn, pt, lengths, *pool)
    assert p.max_abs == 0.0
    written = p.torch[0] != to_numpy(_tcast(torch.from_numpy(pool[0]), kv))
    assert written[1].sum() > 0 and written[0].sum() == 0


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_prefill_twin_matches_pallas(kv):
    k, v, ks, vs = _pool(kv, seed=7)
    S = 20
    q = np.random.default_rng(8).standard_normal(
        (3, S, HQ, HD)).astype(np.float32)
    scales = () if ks is None else (ks, vs)

    def run(lib, mod, cast, layer, **extra):
        def fn(q, k, v, pt, ln, *sc):
            kw = {} if not sc else dict(k_scales=sc[0], v_scales=sc[1])
            return mod.paged_prefill_attention(
                cast(q, kv), cast(k, kv), cast(v, kv), pt, ln, layer, **kw,
                **extra)
        return fn

    p = run_parity(run(jnp, jpa, _jcast, jnp.int32(1), interpret=True),
                   run(torch, tpa, _tcast, 1), q, k, v, PAGE_TABLE, LENGTHS,
                   *scales)
    p.assert_close(atol=TOL[kv], rtol=TOL[kv])
    assert np.all(p.torch[1][2] == np.float32(tpa.NEG_INF))
    assert np.all(p.torch[0][2] == 0)


@pytest.mark.parametrize("shape,want", [
    # (B, Hkv, MP, ps, T, G) -> (splits, slots a split, rows a block)
    ((1, 8, 67, 512, 1, 2), (32, 1088, 2)),   # the session's 34k decode
    ((1, 8, 257, 128, 1, 2), (33, 1024, 2)),  # one row over 32k, page 128
    ((8, 8, 17, 512, 1, 2), (4, 2176, 2)),    # the engine's 8 rows x 8.2k
    ((8, 8, 17, 512, 5, 2), (4, 2176, 16)),   # its verify forward, T = 5
    ((3, 8, 18, 128, 1, 2), (9, 256, 2)),    # the served rows
    ((3, 2, 5, 8, 16, 2), (1, 64, 16)),       # sweep: 32 rows in 2 blocks
    ((2, 1, 3, 16, 16, 4), (1, 64, 16)),      # sweep: 64 rows in 4 blocks
    ((64, 8, 10, 512, 1, 2), (1, 5120, 2)),   # rows enough: no split
    ((3, 8, 0, 512, 1, 2), (1, 64, 2)),       # no entries: one empty split
])
def test_decode_plan_splits_a_rows_slots(shape, want):
    """decode_plan reads shapes only: every slot of a row lies in exactly
    one split, whole 64-slot stages a split; a block's rows cover the T * G
    query rows; the launch fits the card's two resident blocks an SM in
    one wave, and fills at least half of it where the slots allow."""
    B, Hkv, MP, ps, T, G = shape
    plan = tpa.decode_plan(*shape)
    assert (plan.splits, plan.span, plan.rows) == want
    V = max(MP * ps, 1)
    assert plan.span % tpa.DECODE_SLOTS == 0
    assert (plan.splits - 1) * plan.span < V <= plan.splits * plan.span
    assert plan.rows * plan.row_blocks >= T * G > \
        plan.rows * (plan.row_blocks - 1)
    base = B * Hkv * plan.row_blocks
    blocks = base * plan.splits
    assert blocks <= 2 * tpa.SMS or plan.splits == 1
    assert blocks > tpa.SMS or plan.span == tpa.DECODE_SLOTS \
        or base > tpa.SMS
    with pytest.raises(ValueError):
        tpa.decode_plan(B, Hkv, MP, ps, 0, G)


@pytest.mark.parametrize("fresh_in_pages", [False, True])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_decode_split_merge_equals_unsplit(n, fresh_in_pages):
    """The arithmetic of the decode kernel's meeting: the plain decode over
    a row's entries cut into n disjoint slot_base views (contiguous runs of
    entries, as decode_plan cuts a row's slots; dead entries and an empty
    split among them), merged in split order with merge_partials, then the
    separate fresh tokens folded in once, equals the unsplit result."""
    k, v, _, _ = _pool("float32", seed=12)
    rng = np.random.default_rng(13)
    B, T = 3, 4
    q, kn, vn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, T, HQ, HD), (B, T, HKV, HD), (B, T, HKV, HD)))
    pt = torch.from_numpy(PAGE_TABLE)
    if fresh_in_pages:
        pt = pt.clone()
        pt[2, 0] = 13  # row 2's fresh tokens are stored in page 13
    ln = torch.from_numpy(LENGTHS)
    sb = tpa.default_slot_base(pt, PS)
    sb[0, 1] = -1  # a dead entry inside row 0's range
    pool = (torch.from_numpy(k), torch.from_numpy(v), pt, ln, 1)
    kw = dict(fresh_in_pages=fresh_in_pages, return_lse=True)
    want, want_lse = tpa.paged_decode_attention_torch(
        q, kn, vn, *pool, slot_base=sb, **kw)
    MP = pt.shape[1]
    per = -(-MP // n)
    out = lse = None
    for i in range(n):
        view = torch.full_like(sb, -1)
        view[:, i * per:(i + 1) * per] = sb[:, i * per:(i + 1) * per]
        o, l = tpa.paged_decode_attention_torch(
            q, kn, vn, *pool, slot_base=view, fold_fresh=0, **kw)
        out, lse = (o, l) if out is None else tpa.merge_partials(
            out, lse, o, l)
    if not fresh_in_pages:  # the fresh tokens alone, folded once
        o, l = tpa.paged_decode_attention_torch(
            q, kn, vn, *pool, slot_base=torch.full_like(sb, -1), **kw)
        out, lse = tpa.merge_partials(out, lse, o, l)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=2e-6,
                               rtol=0)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_prefill_bf16_rounding_matches_pallas(kv):
    """bf16 queries: the plain prefill rounds as the tensor-core kernel
    does (bf16 q and K/V or codes, scales on the fp32 scores, the weights
    rounded to bf16 for the product with V). Against the Pallas kernel in
    interpret mode, which keeps the weights in fp32: out within 1e-2 (a
    bf16 output and the weights' rounding, 2^-9 of each, over values up to
    ~2), lse within 2e-5 (the same fp32 scores but for the scale's place)."""
    k, v, ks, vs = _pool(kv, seed=14)
    q = np.random.default_rng(15).standard_normal(
        (3, 20, HQ, HD)).astype(np.float32)
    pool = [k, v] if kv == "int8" else [x.astype(np.float32) for x in (k, v)]
    jscales = {} if ks is None else dict(k_scales=jnp.asarray(ks),
                                         v_scales=jnp.asarray(vs))
    tscales = {} if ks is None else dict(k_scales=torch.from_numpy(ks),
                                         v_scales=torch.from_numpy(vs))
    jpool = [_jcast(jnp.asarray(x), kv) for x in pool]
    tpool = [_tcast(torch.from_numpy(x), kv) for x in pool]
    want, want_lse = jpa.paged_prefill_attention(
        jnp.asarray(q).astype(jnp.bfloat16), *jpool, jnp.asarray(PAGE_TABLE),
        jnp.asarray(LENGTHS), jnp.int32(1), interpret=True, **jscales)
    got, got_lse = tpa.paged_prefill_attention(
        torch.from_numpy(q).to(torch.bfloat16), *tpool,
        torch.from_numpy(PAGE_TABLE), torch.from_numpy(LENGTHS), 1,
        **tscales)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=2e-5)
    # the weights really are rounded: the fp32 computation differs
    fp32, _ = tpa.paged_prefill_attention_torch(
        torch.from_numpy(q).to(torch.bfloat16).float(),
        *[t.float() if kv == "bfloat16" else t for t in tpool],
        torch.from_numpy(PAGE_TABLE), torch.from_numpy(LENGTHS), 1,
        **tscales)
    assert not torch.equal(got.float(), fp32.to(torch.bfloat16).float())
    assert np.all(got_lse.numpy()[2] == np.float32(tpa.NEG_INF))


def test_merge_lse_matches_jax():
    rng = np.random.default_rng(9)
    o1, o2 = (rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 4, 5)).astype(np.float32)
              for _ in range(2))
    l1[0, 1] = tpa.NEG_INF       # one partial empty
    l1[1, 2] = l2[1, 2] = tpa.NEG_INF  # both empty
    p = run_parity(jpa.merge_lse, tpa.merge_lse, o1, l1, o2, l2)
    p.assert_close(atol=2e-6, rtol=2e-6)


# ----------------------------------------------------------------- pool


def _cfg_llm(layers=2):
    return LLMConfig(vocab_size=100, hidden_size=HQ * HD,
                     intermediate_size=64, num_hidden_layers=layers,
                     num_attention_heads=HQ, num_key_value_heads=HKV)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 4, 16)).astype(
        np.float32)
    x[0, 0] = 0.0                                    # amax 0 -> scale 1
    x[0, 1] = [127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127] * 2  # ties
    p = run_parity(jpk.quantize_kv, tpk.quantize_kv, x)
    assert p.max_abs == 0.0
    assert list(p.torch[0][0, 1, :8]) == [127, 0, 2, 2, 0, -2, 4, -127]
    with pytest.raises(ValueError):
        tpk.quantize_kv(torch.from_numpy(x), bits=16)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_allocate_and_write_match_jax(kv):
    """Allocation over three steps (a prompt, a decode token, a rolled-back
    row) and both write paths (T > 1 with valid_t, T == 1) leave identical
    page tables, bump heads, pools and gathers."""
    cfg = _cfg_llm(layers=3)
    rng = np.random.default_rng(2)
    B = 2
    jc = jpk.PagedKVCache.zeros(cfg, B, 16, 4, 8, dtype=jnp.float32,
                                kv_dtype=kv)
    tc = tpk.PagedKVCache.zeros(port_config(cfg), B, 16, 4, 8, dtype=torch.float32,
                                kv_dtype=kv)
    steps = [(np.array([9, 5]), 9), (np.array([1, 1]), 1),
             (np.array([3, 6]), 6)]
    for new, T in steps:
        kn = rng.standard_normal((3, B, T, HKV, HD)).astype(np.float32)
        vn = rng.standard_normal((3, B, T, HKV, HD)).astype(np.float32)
        jc = jpk.allocate_rows(jc, jnp.asarray(new, jnp.int32))
        tc = tpk.allocate_rows(tc, torch.from_numpy(new.astype(np.int32)))
        vt = None if T == 1 else new.astype(np.int32)
        jc = jpk.write_all_layers(jc, jnp.asarray(kn), jnp.asarray(vn),
                                  valid_t=None if vt is None
                                  else jnp.asarray(vt))
        tc = tpk.write_all_layers(tc, torch.from_numpy(kn),
                                  torch.from_numpy(vn),
                                  valid_t=None if vt is None
                                  else torch.from_numpy(vt))
        jc = jpk.advance_lengths(jc, jnp.asarray(new, jnp.int32))
        tc = tpk.advance_lengths(tc, torch.from_numpy(new.astype(np.int32)))
        if T == 1:  # roll row 1 back by one token: its page is reused
            jc = jc._replace(lengths=jc.lengths - jnp.asarray([0, 1]))
            tc = dataclasses.replace(
                tc, lengths=tc.lengths - torch.tensor([0, 1], dtype=torch.int32))
    names = ["k_pages", "v_pages", "page_table", "lengths", "next_page"] + (
        ["k_scales", "v_scales"] if kv else [])
    for n in names:
        np.testing.assert_array_equal(to_numpy(getattr(tc, n)),
                                      np.asarray(getattr(jc, n)), err_msg=n)
    for layer in range(3):
        for a, b in zip(tpk.gather_row_kv(tc, layer),
                        jpk.gather_row_kv(jc, layer)):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    kn = rng.standard_normal((B, 2, HKV, HD)).astype(np.float32)
    jc = jpk.write_tokens(jc, 1, jnp.asarray(kn), jnp.asarray(kn))
    tc = tpk.write_tokens(tc, 1, torch.from_numpy(kn), torch.from_numpy(kn))
    np.testing.assert_array_equal(to_numpy(tc.k_pages),
                                  np.asarray(jc.k_pages))


def test_pool_refuses_what_is_not_ported():
    cfg = _cfg_llm()
    # sequence-sharded pools are ported: per-shard heads, each past its
    # shard's null page; pages that do not split over the shards raise
    for kw in (dict(n_shards=2), dict(n_shards=4, kv_dtype="int4")):
        pool = tpk.PagedKVCache.zeros(port_config(cfg), 1, 8, 4, 4, **kw)
        n = kw["n_shards"]
        assert pool.next_page.tolist() == [d * (8 // n) + 1 for d in range(n)]
        with pytest.raises(ValueError):
            tpk.PagedKVCache.zeros(port_config(cfg), 1, 9, 4, 4, **kw)
    # an int4 pool is ported: packed bytes, half the int8 pool's
    assert tpk.PagedKVCache.zeros(port_config(cfg), 1, 8, 4, 4,
                                  kv_dtype="int4").k_pages.shape[-1] == HD // 2


def test_pool_check_takes_the_kernels_head_dims():
    """The paged wrappers' pool check takes head dims 64, 96 (Phi-3's) and
    128 over a pool in the queries' dtype, int8 codes and packed int4
    bytes, and refuses 32 and 80, as the kernels do."""
    for hd in (64, 96, 128, 32, 80):
        for bits in (0, 8, 4):
            dt = torch.bfloat16 if bits == 0 else torch.int8
            pages = torch.zeros(1, HKV, 3, 4, hd // 2 if bits == 4 else hd,
                                dtype=dt)
            scales = None if bits == 0 else torch.zeros(1, HKV, 3, 1, 4)
            args = (pages, pages, scales, scales, torch.bfloat16,
                    pages.device, hd)
            if hd in (64, 96, 128):
                assert tpa._check_pool(*args) == bits
            else:
                with pytest.raises(ValueError, match="head dim"):
                    tpa._check_pool(*args)


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor on neither the CPU nor a CUDA device is refused, not run."""
    q = torch.zeros(1, 1, HQ, 64, device="meta")
    pages = torch.zeros(1, HKV, 2, 4, 64, device="meta")
    idx = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    ln = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no paged_decode kernel"):
        tpa.paged_decode_attention(q, None, None, pages, pages, idx, ln, 0,
                                   fresh_in_pages=True)
    with pytest.raises(ValueError, match="no paged_prefill kernel"):
        tpa.paged_prefill_attention(q, pages, pages, idx, ln, 0)
    with pytest.raises(ValueError, match="no paged_store kernel"):
        tpa.store_fresh_token(q[:, :, :HKV], q[:, :, :HKV], pages, pages,
                              idx, ln, 0)


# ---------------------------------------------------------------- model

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


@pytest.fixture(scope="module")
def models():
    """JAX params and the port's model from them. The wqkv kernel is
    sharpened so that the random init's scores are not near uniform and
    the tokens depend on the positions."""
    cfg = _vlm_cfg()
    params = jax_init(jax.random.PRNGKey(0), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    return cfg, params, from_jax_params(jax.tree.map(np.asarray, params),
                                        port_config(cfg))


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("prompt", [13, 24])
def test_llm_forward_paged_matches_jax(models, prompt, kv):
    """Prefill (the <= 16-token fold or the flash prefill into empty
    pages), then decode steps (store, then attend) crossing page
    boundaries: logits within 2e-5 of JAX's paged path at every step."""
    cfg, params, model = models
    lc = cfg.llm
    total = prompt + 5
    ids = np.random.default_rng(prompt).integers(0, 300, (1, total))
    pos = np.arange(total, dtype=np.float32)[None] * 0.75
    jc = jpk.allocate_rows(
        jpk.PagedKVCache.zeros(lc, 1, 12, 4, 10, dtype=jnp.float32,
                               kv_dtype=kv), jnp.asarray([prompt]))
    tc = tpk.allocate_rows(
        tpk.PagedKVCache.zeros(port_config(cfg).llm, 1, 12, 4, 10, dtype=torch.float32,
                               kv_dtype=kv), torch.tensor([prompt]))
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
                model.llm, lc, input_ids=torch.from_numpy(ids[:, t0:t1]),
                rope_pos_ids=torch.from_numpy(pos[:, t0:t1]), paged_cache=tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                       rtol=2e-5, err_msg=f"step {t0}")
            jc = jc._replace(lengths=jnp.asarray([t1], jnp.int32))
            tc = dataclasses.replace(tc, lengths=torch.tensor(
                [t1], dtype=torch.int32))
    if kv is None:  # int8 values may round a tie the other way
        ref = np.asarray(jc.k_pages)
        np.testing.assert_allclose(to_numpy(tc.k_pages), ref,
                                   atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("splits,kv", [((22, 38), None),
                                       ((18, 20, 22), None),
                                       ((25, 35), "int8")])
def test_chunked_prefill_matches_jax(models, splits, kv):
    cfg, params, model = models
    lc = cfg.llm
    S = sum(splits)
    ids = np.random.default_rng(1).integers(0, 300, (1, S))
    pos = np.arange(S, dtype=np.float32)[None]
    jc = jpk.PagedKVCache.zeros(lc, 1, 32, 8, 12, dtype=jnp.float32,
                                kv_dtype=kv)
    tc = tpk.PagedKVCache.zeros(port_config(cfg).llm, 1, 32, 8, 12, dtype=torch.float32,
                                kv_dtype=kv)
    off = 0
    for n in splits:
        jl, jc = jax_chunked(params["llm"], lc, jc,
                             input_ids=jnp.asarray(ids[:, off:off + n]),
                             rope_pos_ids=jnp.asarray(pos[:, off:off + n]),
                             attn_impl="jnp")
        tl, tc = chunked_prefill(model.llm, port_config(cfg).llm, tc,
                                 input_ids=torch.from_numpy(
                                     ids[:, off:off + n]),
                                 rope_pos_ids=torch.from_numpy(
                                     pos[:, off:off + n]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                                   rtol=2e-5, err_msg=f"chunk at {off}")
        off += n
        if kv:
            # k/v agree to fp32 rounding, so scales agree to 1e-5 and a
            # value on a rounding tie may quantize one step apart: allow a
            # few, then give the port JAX's pool so the next chunk attends
            # over equal inputs
            for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
                t, j = getattr(tc, name), np.array(getattr(jc, name))
                if t.dtype == torch.int8:
                    assert np.count_nonzero(t.numpy() != j) <= 1e-3 * j.size
                else:
                    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5)
                t.copy_(torch.from_numpy(j))
    assert int(tc.lengths[0]) == S == int(jc.lengths[0])


def test_chunked_prefill_ragged_rows_match_jax(models):
    """Right-padded chunks (segment 0) write no pages and advance each row
    by its own count."""
    cfg, params, model = models
    lc = cfg.llm
    ids = np.random.default_rng(3).integers(0, 300, (2, 48))
    lens = np.array([48, 41])
    jc = jpk.PagedKVCache.zeros(lc, 2, 64, 8, 12, dtype=jnp.float32)
    tc = tpk.PagedKVCache.zeros(port_config(cfg).llm, 2, 64, 8, 12, dtype=torch.float32)
    seg = (np.arange(20)[None] < (lens - 28)[:, None]).astype(np.int32)
    chunks = [(ids[:, :28], None), (ids[:, 28:], seg)]
    for x, sg in chunks:
        jl, jc = jax_chunked(params["llm"], lc, jc, input_ids=jnp.asarray(x),
                             segment_ids=None if sg is None
                             else jnp.asarray(sg), attn_impl="jnp")
        tl, tc = chunked_prefill(model.llm, port_config(cfg).llm, tc,
                                 input_ids=torch.from_numpy(x),
                                 segment_ids=None if sg is None
                                 else torch.from_numpy(sg))
        valid = np.ones(x.shape, bool) if sg is None else sg.astype(bool)
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   atol=2e-5, rtol=2e-5)
    assert list(tc.lengths.numpy()) == [48, 41] == list(np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.k_pages.numpy() != 0,
                                  np.asarray(jc.k_pages) != 0)


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


@pytest.mark.parametrize("kv", [None, "int8"])
def test_paged_generate_matches_jax(models, kv):
    """A ragged batch (image row and text row) decodes through pages of 4
    tokens: greedy tokens, steps and lengths identical to JAX's paged
    generate."""
    cfg, params, model = models
    ids, plen, pos, pixels, flags = _batch(cfg)
    gc = dict(max_new_tokens=7, eos_token_ids=(7,))
    paged = dict(cache_mode="paged", page_size=4, kv_dtype=kv)
    jt, jn, jl = jax_generate(
        params, cfg, JaxGenerationConfig(**gc), jnp.asarray(ids),
        jnp.asarray(plen), jnp.asarray(pos), jnp.asarray(pixels),
        jnp.asarray(flags), IMG, attn_impl="jnp", **paged)
    tt, tn, tl = generate(
        model, port_config(cfg), GenerationConfig(**gc), torch.from_numpy(ids),
        torch.from_numpy(plen), torch.from_numpy(pos),
        torch.from_numpy(pixels), torch.from_numpy(flags), IMG, **paged)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tn == int(jn)


def test_paged_stream_generate_matches_jax(models):
    """stream_generate over pages of 8 (a 10-token prompt takes the <= 16
    fold): the same chunks as JAX's paged stream, and the same tokens as the
    port's paged generate."""
    cfg, params, model = models
    ids = np.arange(40, 50, dtype=np.int32)[None]
    pos = np.arange(10, dtype=np.float32)[None]
    pixels = np.zeros((1, 3, 56, 56), np.float32)
    flags = np.zeros((1,), np.int32)
    kw = dict(cache_mode="paged", page_size=8)
    want = [np.asarray(c) for c in jax_stream(
        params, cfg, JaxGenerationConfig(max_new_tokens=9), ids, pos, pixels,
        flags, IMG, chunk=4, attn_impl="jnp", **kw)]
    got = list(stream_generate(model, port_config(cfg), GenerationConfig(max_new_tokens=9),
                               ids, pos, pixels, flags, IMG, chunk=4, **kw))
    assert [c.tolist() for c in got] == [c.tolist() for c in want]
    tokens, _, lens = generate(
        model, port_config(cfg), GenerationConfig(max_new_tokens=9), torch.from_numpy(ids),
        torch.tensor([10]), torch.from_numpy(pos), torch.from_numpy(pixels),
        torch.from_numpy(flags), IMG, **kw)
    assert np.concatenate(got).tolist() == \
        tokens[0, :int(lens[0])].tolist()
