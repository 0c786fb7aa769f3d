"""The port's sequence-parallel path against the JAX package's, on the CPU
in fp32 at small sizes (and the fused ring's bf16 rounding against the
flash forward's): the zigzag helpers, the scan ring and the fused
ring's plain version against ``ring_attention`` / ``fused_ring_attention``
under ``shard_map`` on the forced host devices (the fused Pallas kernel in
interpret mode), the ring's gradients, the half-chunk branch choice,
all-padding rows, Ulysses, the model forward and the train step under a
sharding context against JAX under a ``seq`` mesh, the MM-NIAH-long
teacher-forced eval, and the CLI with ``--mesh_seq``.

The port keeps every shard of the ``seq`` axis in one tensor: rank r's rows
are ``[r S/n, (r + 1) S/n)`` of the global (zigzag-permuted) sequence, which
is exactly the array the JAX tests hand to ``shard_map``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from v2pe_tpu.core.config import LLMConfig, MeshConfig, VLMConfig, VisionConfig
from v2pe_tpu.evalkit import mm_niah_long as jniah
from v2pe_tpu.models import internvl_chat as jchat
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.ops.attention import AttnStatics
from v2pe_tpu.ops.attention import flash_attention as jflash
from v2pe_tpu.parallel import context as jctx
from v2pe_tpu.parallel import ring as jring
from v2pe_tpu.parallel import ring_fused as jfused
from v2pe_tpu.parallel import ulysses as julysses
from v2pe_tpu.parallel.mesh import make_mesh
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.core import checkpoint as ckpt
from v2pe_tpu_torch.core import config as tconfig
from v2pe_tpu_torch.evalkit import mm_niah_long as tniah
from v2pe_tpu_torch.models import internvl_chat as tchat
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params
from v2pe_tpu_torch.ops import attention as tattn
from v2pe_tpu_torch.ops.flash_fwd import NEG_INF
from v2pe_tpu_torch.parallel import context as tctx
from v2pe_tpu_torch.parallel import ring as tring
from v2pe_tpu_torch.parallel import ring_fused as tfused
from v2pe_tpu_torch.parallel import ulysses as tulysses
from v2pe_tpu_torch.train import optimizer as topt
from v2pe_tpu_torch.train import synth as tsynth
from v2pe_tpu_torch.train import train_step as tstep

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import tokenizer, toy_dataset  # noqa: F401
from .torch_parity import port_config

FWD_TOL = 2e-5   # fp32 forward, on live rows (the JAX ring tests' limit)
GRAD_TOL = 3e-4  # ring gradients (the JAX fused-ring test's limit)
D = 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _zigzag(x: np.ndarray, world: int, axis: int = 1) -> np.ndarray:
    return np.concatenate([np.asarray(jring.zigzag_shard(
        jnp.asarray(x), r, world, axis=axis)) for r in range(world)],
        axis=axis)


def _zig_positions(b: int, s: int, world: int) -> np.ndarray:
    pos = np.concatenate([jring.zigzag_global_positions(s, r, world)
                          for r in range(world)])
    return np.broadcast_to(pos, (b, s)).astype(np.int32).copy()


def _inputs(seed=0, b=1, s=512, hq=4, hkv=2, pad=8):
    """q, k, v and three packed segments with a padded tail, in global
    order (the JAX ring tests' inputs, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, D)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, D)).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[:, s // 3: 2 * s // 3] = 2
    seg[:, 2 * s // 3:] = 3
    if pad:
        seg[:, -pad:] = 0
    return q, k, v, seg


def _jax_ring(entry, world, args, **kw):
    """``entry`` (a per-device ring attention) under shard_map over the
    first ``world`` host devices, on zigzag-layout arrays."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))

    def fn(q, k, v, sq, sk, pq, pk):
        return entry(q, k, v, axis_name="seq", q_segment_ids=sq,
                     kv_segment_ids=sk, q_positions=pq, kv_positions=pk,
                     **kw)

    return jax.shard_map(fn, mesh=mesh, in_specs=(P(None, "seq"),) * 7,
                         out_specs=P(None, "seq"), check_vma=False)(
        *[jnp.asarray(a) for a in args])


def _live(seg):
    return (np.asarray(seg) != 0)[..., None, None]


# ---------------------------------------------------------------- helpers


@pytest.mark.parametrize("world", [2, 4, 8])
def test_zigzag_helpers_equal(world):
    x = np.random.default_rng(world).standard_normal(
        (2, 16 * world, 3)).astype(np.float32)
    for r in range(world):
        np.testing.assert_array_equal(
            tring.zigzag_shard(_t(x), r, world).numpy(),
            np.asarray(jring.zigzag_shard(jnp.asarray(x), r, world)))
        np.testing.assert_array_equal(
            tring.zigzag_global_positions(16 * world, r, world),
            jring.zigzag_global_positions(16 * world, r, world))
    xz = _zigzag(x, world)
    np.testing.assert_array_equal(
        tring.zigzag_unshard(_t(xz), world).numpy(), x)
    np.testing.assert_array_equal(
        np.asarray(jring.zigzag_unshard(jnp.asarray(xz), world)), x)
    # along another axis, as the lse (B, H, S) is laid out
    xt = np.ascontiguousarray(xz.transpose(0, 2, 1))
    np.testing.assert_array_equal(
        tring.zigzag_unshard(_t(xt), world, axis=2).numpy(),
        x.transpose(0, 2, 1))
    with pytest.raises(ValueError):
        tring.zigzag_shard(_t(x[:, :-1]), 0, world)


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("causal", [True, False])
def test_scan_ring_forward_matches_jax_and_dense(causal):
    world = 4
    q, k, v, seg = _inputs(seed=0)
    args = [_zigzag(x, world) for x in (q, k, v, seg, seg)] + \
        [_zig_positions(1, 512, world)] * 2
    want = np.asarray(_jax_ring(jring.ring_attention, world, args,
                                causal=causal, impl="jnp", block_q=32,
                                block_k=32))
    targs = [_t(a) for a in args]
    got = tring.ring_attention(
        *targs[:3], seq_shards=world, q_segment_ids=targs[3],
        kv_segment_ids=targs[4], q_positions=targs[5], kv_positions=targs[6],
        causal=causal, block_q=32)
    live = _live(args[3])
    np.testing.assert_allclose(got.numpy() * live, want * live, rtol=FWD_TOL,
                               atol=FWD_TOL)
    dense = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                              q_segment_ids=jnp.asarray(seg),
                              kv_segment_ids=jnp.asarray(seg), causal=causal,
                              impl="jnp"))
    np.testing.assert_allclose(
        tring.zigzag_unshard(got, world).numpy() * _live(seg),
        dense * _live(seg), rtol=FWD_TOL, atol=FWD_TOL)


def test_fused_plain_forward_matches_jax_fused_kernel_interpreted():
    """The fused ring's plain version (what CPU tensors take, and what the
    CUDA kernel is held against on the card) against the Pallas kernel in
    interpret mode on 4 host devices x 64 tokens each, and against the scan
    ring and dense attention; lse too, against the scan ring's."""
    world = 4
    q, k, v, seg = _inputs(seed=5, s=256, hq=2, hkv=1)
    args = [_zigzag(x, world) for x in (q, k, v, seg, seg)] + \
        [_zig_positions(1, 256, world)] * 2
    want = np.asarray(_jax_ring(jfused.fused_ring_attention, world, args,
                                causal=True, block_q=32, block_k=32))
    targs = [_t(a) for a in args]
    got, lse = tfused.fused_ring_fwd(world, *targs, causal=True,
                                     scale=D ** -0.5)
    live = _live(args[3])
    np.testing.assert_allclose(got.numpy() * live, want * live, rtol=FWD_TOL,
                               atol=FWD_TOL)
    scan, scan_lse = tring._ring_fwd_impl(
        world, tring.RingStatics(True, D ** -0.5, 32), *targs)
    np.testing.assert_allclose(got.numpy(), scan.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), scan_lse.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
    dense = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                              q_segment_ids=jnp.asarray(seg),
                              kv_segment_ids=jnp.asarray(seg), causal=True,
                              impl="jnp"))
    np.testing.assert_allclose(
        tring.zigzag_unshard(got, world).numpy() * _live(seg),
        dense * _live(seg), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("b,s,world,causal", [(1, 256, 4, True),
                                              (2, 200, 2, False)])
def test_fused_plain_bf16_matches_flash_plain_on_the_whole_sequence(
        b, s, world, causal):
    """bf16: the fused ring's plain version inherits the flash forward's
    bf16 rounding points (bf16 operands, P rounded for the PV product), so
    its zigzag output un-permuted equals the flash forward's plain version
    on the unsharded bf16 sequence: the same weights, summed over the keys
    in hop order instead of in sequence order."""
    q, k, v, seg = _inputs(seed=11, b=b, s=s)
    q, k, v = (_t(x).bfloat16() for x in (q, k, v))
    seg = _t(seg)
    pos = _t(np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy())
    zz = [torch.cat([tring.zigzag_shard(x, r, world) for r in range(world)],
                    dim=1) for x in (q, k, v, seg, seg, pos, pos)]
    got, got_lse = tfused.fused_ring_fwd(world, *zz, causal=causal,
                                         scale=D ** -0.5)
    want, want_lse = tfused.flash_attention_fwd_torch(
        q, k, v, seg, seg, pos, pos, causal=causal, scale=D ** -0.5)
    assert got.dtype == torch.bfloat16
    # the fp32 sums in another order: the bf16 output one step apart at
    # most (2^-7 at |out| < 2), lse to fp32 rounding
    np.testing.assert_allclose(
        tring.zigzag_unshard(got, world).float().numpy(),
        want.float().numpy(), atol=2.0 ** -7, rtol=0)
    np.testing.assert_allclose(
        tring.zigzag_unshard(got_lse, world, axis=2).numpy(),
        want_lse.numpy(), atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("b,s,world,causal", [(2, 256, 4, True),
                                              (1, 512, 8, False),
                                              (1, 200, 2, True),
                                              (1, 64, 1, True)])
def test_fused_entry_matches_scan_entry(b, s, world, causal):
    """``fused_ring_attention`` and ``ring_attention`` agree at batch 2,
    8 ranks, shards that no kernel tile divides, and one rank."""
    q, k, v, seg = _inputs(seed=s, b=b, s=s)
    args = [_t(_zigzag(x, world)) for x in (q, k, v, seg)]
    pos = _t(_zig_positions(b, s, world))
    kw = dict(seq_shards=world, q_segment_ids=args[3],
              kv_segment_ids=args[3], q_positions=pos, kv_positions=pos,
              causal=causal)
    got = tfused.fused_ring_attention(*args[:3], **kw)
    want = tring.ring_attention(*args[:3], **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)


# --------------------------------------------------------------- gradients


@pytest.mark.parametrize("mode", ["scan", "fused"])
def test_ring_gradients_match_jax(mode):
    """dq, dk, dv of the port's ring (scan forward or fused forward, the
    scan ring's backward) against ``jax.grad`` of the JAX ring, with the
    half-chunk rectangles in play (halves of 64 rows, block_q 32)."""
    world, S = 4, 512
    q, k, v, seg = _inputs(seed=1, s=S)
    segz, pos = _zigzag(seg, world), _zig_positions(1, S, world)
    live = _live(segz)

    def jloss(qz, kz, vz):
        o = _jax_ring(jring.ring_attention, world,
                      (qz, kz, vz, segz, segz, pos, pos), causal=True,
                      impl="jnp", block_q=32, block_k=32)
        return jnp.sum(jnp.sin(jnp.where(live, o, 0.0)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *[jnp.asarray(_zigzag(x, world)) for x in (q, k, v)])
    leaves = [_t(_zigzag(x, world)).requires_grad_() for x in (q, k, v)]
    entry = tring.ring_attention if mode == "scan" else \
        tfused.fused_ring_attention
    o = entry(*leaves, seq_shards=world, q_segment_ids=_t(segz),
              kv_segment_ids=_t(segz), q_positions=_t(pos),
              kv_positions=_t(pos), causal=True, block_q=32)
    torch.where(_t(live), o, 0.0).sin().sum().backward()
    for a, b, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


# ---------------------------------------------------- the five-way choice


def _half_skip_layout(seed):
    """Segments and positions of ``test_ring_half_chunk_skip_parity``
    (world 4, 1024 tokens, two segments, 32 padded), per seed a variant:
    0 zigzag, 1 contiguous, 2 zigzag with random segment cuts."""
    world, S = 4, 1024
    rng = np.random.default_rng(seed)
    seg = np.ones((1, S), np.int32)
    if seed == 2:
        cuts = np.sort(rng.choice(np.arange(1, S - 32), 5, replace=False))
        seg[0] = 1 + np.searchsorted(cuts, np.arange(S), side="right")
    else:
        seg[:, S // 2:] = 2
    seg[:, -32:] = 0
    if seed == 1:
        return world, seg, np.arange(S, dtype=np.int32)[None].copy()
    return world, _zigzag(seg, world), _zig_positions(1, S, world)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_branch_table_matches_jax_branch_index(seed, causal):
    """The port decides all n x n (rank, chunk) pairs in one tensor pass;
    JAX decides one pair per hop with ``_branch_index`` (and
    ``_chunk_has_work`` without half chunks)."""
    world, seg, pos = _half_skip_layout(seed)
    Sl = seg.shape[1] // world
    jst = AttnStatics(causal=causal, scale=1.0, block_q=32, block_k=32,
                      impl="jnp", ordered=False, interpret=False)
    shard = lambda x, r: jnp.asarray(x[:, r * Sl:(r + 1) * Sl])
    for block_q, fn in ((32, jring._branch_index),
                        (4096, jring._chunk_has_work)):
        want = np.array([[int(fn(jst, shard(seg, r), shard(seg, c),
                                 shard(pos, r), shard(pos, c)))
                          for c in range(world)] for r in range(world)])
        got = tring.branch_table(tring.RingStatics(causal, 1.0, block_q),
                                 world, _t(seg), _t(seg), _t(pos), _t(pos))
        np.testing.assert_array_equal(got.numpy(), want)
    if seed == 0 and causal:  # the zigzag pattern: diagonal full, below it
        # q_full x k_lo, above it q_hi x k_full
        want = np.where(np.eye(4, dtype=bool), 1,
                        np.where(np.tri(4, dtype=bool), 2, 3))
        np.testing.assert_array_equal(tring.branch_table(
            tring.RingStatics(True, 1.0, 32), world, _t(seg), _t(seg),
            _t(pos), _t(pos)).numpy(), want)


# ------------------------------------------------------------ padded rows


@pytest.mark.parametrize("mode", ["scan", "fused"])
def test_all_padding_rows_give_zero_and_neg_inf_lse(mode):
    """Rows that are all padding (here the whole last zigzag chunk pair of
    every shard's tail, and in batch row 1 a whole shard) come out 0 with
    lse -1e30, never NaN; their gradients are 0."""
    world, S = 4, 256
    q, k, v, seg = _inputs(seed=3, b=2, s=S, pad=40)
    segz = _zigzag(seg, world)
    segz[1, :S // world] = 0  # batch row 1: rank 0 holds padding only
    pos = _t(_zig_positions(2, S, world))
    args = [_t(_zigzag(x, world)).requires_grad_() for x in (q, k, v)]
    ids = (_t(segz), _t(segz), pos, pos)
    st = tring.RingStatics(True, D ** -0.5, 32)
    if mode == "scan":
        out, lse = tring._ring_fwd_impl(world, st, *args, *ids)
        out2 = tring.ring_flash_attention(world, st, *args, *ids)
    else:
        out, lse = tfused.fused_ring_fwd(world, *args, *ids, causal=True,
                                         scale=st.scale)
        out2 = tfused.fused_ring_flash_attention(world, st, *args, *ids)
    dead = _t(segz == 0)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out[dead] == 0).all()
    assert (lse.transpose(1, 2)[dead] == NEG_INF).all()
    assert (lse.transpose(1, 2)[~dead] > NEG_INF / 2).all()
    out2.sum().backward()
    for a in args:
        assert torch.isfinite(a.grad).all()
    assert (args[0].grad[dead] == 0).all()


def test_chunk_pointer_table_addresses_the_shards():
    """The kernel's table of chunk base pointers: entry [operand, rank] is
    the address of the first element of that rank's shard."""
    n, B, S = 4, 1, 64
    k = torch.zeros(B, S, 2, D)
    v = torch.zeros(B, S, 2, D, dtype=torch.bfloat16)
    seg = torch.zeros(B, S, dtype=torch.int32)
    pos = torch.zeros(B, S, dtype=torch.int32)
    table = tfused.chunk_pointer_table(n, k, v, seg, pos)
    assert table.shape == (4, n) and table.dtype == torch.int64
    for row, t in zip(table.tolist(), (k, v, seg, pos)):
        assert row == [t[0, r * (S // n)].data_ptr() for r in range(n)]


def test_fused_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, seg = (_t(x) for x in _inputs(s=64))
    pos = _t(_zig_positions(1, 64, 4))
    ok = (q, k, v, seg, seg, pos, pos)
    tfused._check(4, *ok)
    wide = [torch.zeros(*t.shape[:-1], 96) for t in (q, k, v)]
    tfused._check(4, *wide, seg, seg, pos, pos)  # Phi-3's head dim
    bad = [
        (4, q[..., :8], k[..., :8], v[..., :8], seg, seg, pos, pos),  # D 8
        (4, *(t[..., :80] for t in wide), seg, seg, pos, pos),        # D 80
        (4, q.double(), k.double(), v.double(), seg, seg, pos, pos),
        (4, q, k, v, seg.long(), seg, pos, pos),
        (4, q.transpose(1, 2), k, v, seg, seg, pos, pos),
        (3, *ok),                                     # 64 rows, 3 shards
        (4, q, k[:, :32], v[:, :32], seg, seg[:, :32], pos, pos[:, :32]),
    ]
    big = [_t(x) for x in _inputs(s=1024)]   # 16 ranks of 64 rows, bf16
    bpos = _t(_zig_positions(1, 1024, 16))
    tfused._check(8, *(t.bfloat16() for t in big[:3]), big[3], big[3], bpos,
                  bpos)
    bad.append((16, *(t.bfloat16() for t in big[:3]), big[3], big[3], bpos,
                bpos))  # a tensor map of each chunk: 8 ranks at most in bf16
    for args in bad:
        with pytest.raises(ValueError):
            tfused._check(*args)
    with pytest.raises(ValueError):
        tfused.fused_ring_fwd(4, *[t.to("meta") for t in ok], causal=True,
                              scale=1.0)


# ----------------------------------------------------------------- ulysses


def test_ulysses_matches_jax():
    world, S = 4, 256
    q, k, v, seg = _inputs(seed=7, s=S, hq=8, hkv=4)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S)).copy()
    args = (q, k, v, seg, seg, pos, pos)
    want = np.asarray(_jax_ring(julysses.ulysses_attention, world, args,
                                causal=True, impl="jnp", block_q=32,
                                block_k=32))
    t = [_t(a) for a in args]
    got = tulysses.ulysses_attention(
        *t[:3], seq_shards=world, q_segment_ids=t[3], kv_segment_ids=t[4],
        q_positions=t[5], kv_positions=t[6], causal=True)
    live = _live(seg)
    np.testing.assert_allclose(got.numpy() * live, want * live, rtol=FWD_TOL,
                               atol=FWD_TOL)
    with pytest.raises(ValueError):
        tulysses.ulysses_attention(
            *t[:3], seq_shards=3, q_segment_ids=t[3], kv_segment_ids=t[4],
            q_positions=t[5], kv_positions=t[6])


# ------------------------------------------------- context and the routing


def test_sharding_context_holds_the_seq_axis_only():
    ctx = tctx.ShardingContext.from_mesh(tconfig.MeshConfig(seq=4),
                                         ring_mode="fused")
    assert (ctx.seq_shards, ctx.pipe_shards, ctx.ring_mode) == (4, 1, "fused")
    assert tctx.current() is None
    with tctx.use_sharding(ctx) as inside:
        assert inside is ctx and tctx.current() is ctx
        with tctx.use_sharding(None):
            assert tctx.current() is None
        assert tctx.current() is ctx
    assert tctx.current() is None
    for axes in (dict(data=2), dict(fsdp=2), dict(tensor=2), dict(pipe=2),
                 dict(seq=2, fsdp=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            tctx.ShardingContext.from_mesh(tconfig.MeshConfig(**axes))
    # seq with pipe, as JAX's pipeline asserts
    with pytest.raises(ValueError, match="seq must be 1"):
        tctx.ShardingContext.from_mesh(tconfig.MeshConfig(seq=2, pipe=2))
    for bad in (dict(seq_shards=2, ring_mode="rdma"), dict(seq_shards=0)):
        with pytest.raises(ValueError):
            tctx.ShardingContext(**bad)


def test_flash_attention_routes_where_jax_does(monkeypatch):
    """Under a context with a sharded seq axis the causal flash call goes
    to the ring; the <=16-token decode route, a bidirectional call, a
    sequence the axis does not divide and ``flash_attention_with_lse`` do
    not."""
    from v2pe_tpu_torch.parallel import shard_attn

    calls = []
    real = shard_attn.ring_flash_attention
    monkeypatch.setattr(shard_attn, "ring_flash_attention",
                        lambda *a: calls.append(a[0]) or real(*a))
    q, k, v, seg = (_t(x) for x in _inputs(seed=2, s=128, pad=0))
    with tctx.use_sharding(tctx.ShardingContext(seq_shards=4)):
        tattn.flash_attention(q, k, v, causal=True)
        assert calls == [4]
        tattn.flash_attention(q, k, v, causal=False)             # the ViT
        tattn.flash_attention(q[:, :8], k, v, causal=True)       # decode
        tattn.flash_attention(q[:, :126], k[:, :126], v[:, :126])
        tattn.flash_attention_with_lse(q, k, v)
        assert calls == [4]
    with tctx.use_sharding(tctx.ShardingContext(seq_shards=1)):
        tattn.flash_attention(q, k, v, causal=True)
    tattn.flash_attention(q, k, v, causal=True)
    assert calls == [4]


def test_chunked_ce_is_one_block_a_shard_under_a_sharded_seq_axis(
        monkeypatch):
    rng = np.random.default_rng(0)
    B, S, Dh, V = 2, 256, 16, 64
    hidden = _t(rng.standard_normal((B, S, Dh)).astype(np.float32))
    head = _t((rng.standard_normal((V, Dh)) * 0.1).astype(np.float32))
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets[rng.random((B, S)) < 0.1] = -100
    w = _t(rng.random((B, S)).astype(np.float32))
    want = float(jchat.chunked_cross_entropy(
        jnp.asarray(hidden.numpy()), jnp.asarray(head.numpy().T),
        jnp.asarray(targets), jnp.asarray(w.numpy()), chunk=64))
    blocks = []
    real = tchat._ce_block
    monkeypatch.setattr(tchat, "_ce_block", lambda h, *a: blocks.append(
        h.shape[1]) or real(h, *a))
    with tctx.use_sharding(tctx.ShardingContext(seq_shards=4)):
        got = tchat.chunked_cross_entropy(hidden, head, _t(targets), w,
                                          chunk=32)
    assert blocks == [64] * 4  # one block per shard, whatever the chunk
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    with tctx.use_sharding(tctx.ShardingContext(seq_shards=1)):
        got = tchat.chunked_cross_entropy(hidden, head, _t(targets), w,
                                          chunk=S)
    assert blocks[4:] == [S]
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ----------------------------------------------------- the model, sharded


def _cfg(vocab=92553):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2),
        rope_pos_id_stride=2)


CFG = _cfg()
B, S = 2, 256


def _batches(seq_shards):
    """``make_synthetic_batch`` of both packages (the same arrays: the
    zigzag permutation is made on the host)."""
    kw = dict(tiles_per_row=1, seq_shards=seq_shards)
    want = jsynth.make_synthetic_batch(CFG, B, S, **kw)
    got = tsynth.make_synthetic_batch(port_config(CFG), B, S, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return want, {k: _t(v) for k, v in got.items()}


@pytest.fixture(scope="module")
def sharded_forward():
    """JAX params, the zigzag batch for 4 shards, and JAX's logits under a
    ``seq=4`` mesh (the scan ring, jnp attention)."""
    params = jax_init(jax.random.PRNGKey(0), CFG)
    jb, tb = _batches(4)
    mesh = make_mesh(MeshConfig(seq=4))

    def fwd(p, b):
        return jchat.forward(
            p, CFG, input_ids=b["input_ids"], pixel_values=b["pixel_values"],
            image_flags=b["image_flags"], rope_pos_ids=b["rope_pos_ids"],
            img_context_token_id=jsynth.IMG_CONTEXT_ID,
            segment_ids=b["segment_ids"],
            token_positions=b["token_positions"],
            vit_gather_idx=b["vit_gather_idx"], attn_impl="jnp").logits

    with jctx.use_sharding(jctx.ShardingContext(mesh=mesh)):
        logits = np.asarray(jax.jit(fwd)(
            params, {k: jnp.asarray(v) for k, v in jb.items()}))
    return params, tb, logits


def _port_logits(model, tb, ctx):
    with torch.inference_mode(), tctx.use_sharding(ctx):
        return tchat.forward(
            model, port_config(CFG), input_ids=tb["input_ids"].long(),
            pixel_values=tb["pixel_values"], image_flags=tb["image_flags"],
            rope_pos_ids=tb["rope_pos_ids"],
            img_context_token_id=tsynth.IMG_CONTEXT_ID,
            segment_ids=tb["segment_ids"],
            token_positions=tb["token_positions"],
            vit_gather_idx=tb["vit_gather_idx"]).logits.numpy()


@pytest.mark.parametrize("mode", ["scan", "fused"])
def test_forward_under_sharding_context_matches_jax_mesh(sharded_forward,
                                                         mode):
    """``internvl_chat.forward`` under ``ShardingContext(seq_shards=4)``
    against JAX under a ``seq=4`` mesh on the same zigzag batch (1e-4 of the
    logits: two layers of fp32 sums in other orders), and against the
    port's own unsharded forward on the un-permuted batch."""
    params, tb, want = sharded_forward
    model = from_jax_params(_np(params), port_config(CFG))
    got = _port_logits(model, tb, tctx.ShardingContext(seq_shards=4,
                                                       ring_mode=mode))
    live = (tb["segment_ids"].numpy() != 0)[..., None]
    scale = np.abs(want * live).max()
    assert np.abs((got - want) * live).max() <= 1e-4 * scale
    # unsharded: the same rows in global order (sort each row's positions)
    order = np.argsort(tb["token_positions"].numpy(), axis=1)
    plain = {k: (torch.from_numpy(np.take_along_axis(
        v.numpy(), order, axis=1)) if v.ndim == 2 and v.shape[1] == S else v)
        for k, v in tb.items()}
    ref = _port_logits(model, plain, None)
    got_sorted = np.take_along_axis(got, order[..., None], axis=1)
    live = (plain["segment_ids"].numpy() != 0)[..., None]
    assert np.abs((got_sorted - ref) * live).max() <= 1e-4 * scale


@pytest.mark.parametrize("seq,mode", [(2, "scan"), (4, "fused")])
def test_make_train_step_seq_sharded_matches_jax(seq, mode):
    """Two steps of ``make_train_step`` under ``MeshConfig(seq=n)`` (remat
    'full', AdamW, warmup 1) against JAX's step under the same mesh: loss,
    grad norm, and the parameters after the steps (the second step is the
    first with a nonzero learning rate)."""
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    params = jax_init(jax.random.PRNGKey(1), CFG)
    model = from_jax_params(_np(params), port_config(CFG))
    jb, tb = _batches(seq)
    mesh = make_mesh(MeshConfig(seq=seq))
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), params)
    params = jstep.shard_params(params, mesh)
    jstate = tx.init(params)
    jfn = jstep.make_train_step(CFG, tx, mesh, jsynth.IMG_CONTEXT_ID,
                                attn_impl="jnp", remat=True, donate=False)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), model,
                               port_config(CFG))
    tstate = opt.init()
    tfn = tstep.make_train_step(
        port_config(CFG), opt, tconfig.MeshConfig(seq=seq),
        img_context_token_id=tsynth.IMG_CONTEXT_ID, remat="full",
        ring_mode=mode)
    jb = {k: jnp.asarray(v) for k, v in jb.items()}
    for i in range(2):
        params, jstate, m = jfn(params, jstate, jb)
        loss, gnorm = tfn(model, tstate, tb)
        np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(gnorm), float(m["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert tctx.current() is None
    want = _jax_state_dict(_np(params), port_config(CFG))
    # 3% of one Adam step (lr 1e-3): the update g / (|g| + eps) turns the
    # ring's other summation order into that much where g is near zero
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=3e-5,
                                   rtol=0, err_msg=n)


# ------------------------------------------------------------ mm_niah_long


@pytest.mark.parametrize("seq_shards,mode", [(1, "scan"), (4, "scan"),
                                             (4, "fused")])
def test_teacher_forced_eval_matches_jax(seq_shards, mode):
    """The teacher-forced long eval: predictions at the answer slots equal
    to the JAX package's (a plain forward, as its own test holds the zigzag
    arm to) and to the port's unsharded run; logits within 1e-4."""
    cfg = _cfg(vocab=300)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    model = from_jax_params(_np(params), port_config(cfg))
    rng = np.random.RandomState(0)
    n = 300
    ids = rng.randint(5, 280, size=n).astype(np.int64)
    span = (n - 10, n)
    pos = np.arange(n, dtype=np.float32)
    pixels = np.zeros((1, 3, 56, 56), np.float32)
    flags = np.zeros((1,), np.int32)
    want = jniah.teacher_forced_eval(
        params, cfg, jniah.build_teacher_forced_inputs(
            ids, span, pos, seq_shards=1, pad_multiple=64),
        pixels, flags, 299, attn_impl="jnp")
    inputs = tniah.build_teacher_forced_inputs(
        ids, span, pos, seq_shards=seq_shards, pad_multiple=64)
    ctx = tctx.ShardingContext(seq_shards=seq_shards, ring_mode=mode)
    plain_inputs = tniah.build_teacher_forced_inputs(ids, span, pos,
                                                     pad_multiple=64)

    def logits_of(inp, ctx):  # global order
        t = lambda a: torch.from_numpy(np.asarray(a))
        with torch.inference_mode(), tctx.use_sharding(ctx):
            out = tchat.forward(
                model, port_config(cfg), input_ids=t(inp["input_ids"]).long(),
                pixel_values=t(pixels), image_flags=t(flags),
                rope_pos_ids=t(inp["rope_pos_ids"]), img_context_token_id=299,
                segment_ids=t(inp["segment_ids"]),
                token_positions=t(inp["token_positions"])).logits
        return out[0].numpy()[inp["inverse_perm"]]

    with tctx.use_sharding(ctx):
        pred = tniah.teacher_forced_eval(model, port_config(cfg), inputs,
                                         pixels, flags, 299)
    np.testing.assert_array_equal(pred, want)
    logits = logits_of(inputs, ctx)
    np.testing.assert_array_equal(
        tniah.extract_answer_prediction(
            logits[np.argsort(inputs["inverse_perm"])][None], inputs), want)
    plain = tniah.teacher_forced_eval(model, port_config(cfg), plain_inputs,
                                      pixels, flags, 299)
    np.testing.assert_array_equal(plain, want)
    ref = logits_of(plain_inputs, None)
    np.testing.assert_allclose(logits[:n], ref[:n],
                               atol=1e-4 * float(np.abs(ref[:n]).max()))


# --------------------------------------------------------------------- CLI


def test_cli_mesh_seq_fused_trains_and_saves(toy_dataset, tmp_path):
    from v2pe_tpu_torch.train import cli

    tok_dir = str(tmp_path / "tok")
    _toy_tokenizer().save_pretrained(tok_dir)
    argv = ["--model_preset", "debug_tiny", "--tokenizer", tok_dir,
            "--meta_path", toy_dataset, "--output_dir",
            str(tmp_path / "out"), "--max_steps", "2", "--save_steps", "2",
            "--log_steps", "1", "--max_packed_tokens", "1024",
            "--max_tiles", "4", "--max_dynamic_patch", "1",
            "--warmup_steps", "1", "--learning_rate", "1e-3",
            "--dtype", "float32", "--platform", "cpu", "--sync_save",
            "--mesh_seq", "2", "--ring_mode", "fused"]
    calls = []
    real = tfused.fused_ring_fwd
    tfused.fused_ring_fwd = lambda *a, **kw: calls.append(a[0]) or \
        real(*a, **kw)
    try:
        model, _, step = cli.main(argv)
    finally:
        tfused.fused_ring_fwd = real
    assert step == 2
    assert ckpt.list_checkpoints(str(tmp_path / "out")) == [2]
    assert calls and set(calls) == {2}  # the ring ran, over 2 shards
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        lines = f.readlines()
    assert len(lines) == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())
