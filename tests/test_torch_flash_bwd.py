"""The port's flash-attention backward (``v2pe_tpu_torch/ops/flash_bwd.py``,
its plain twin on the CPU) against the JAX package's: the Pallas kernels in
interpret mode and the jnp backward, on the same numpy inputs in fp32.
Also the port's ``flash_attention`` gradient against ``jax.grad`` of JAX's,
and the rotary transpose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.ops import attention as jattn
from v2pe_tpu.ops.flash_pallas_bwd import flash_attention_bwd_pallas
from v2pe_tpu_torch.ops import attention as tattn
from v2pe_tpu_torch.ops import flash_bwd
from v2pe_tpu_torch.ops.rope import rope_transpose

from .torch_parity import run_parity

TOL = dict(rtol=1e-4, atol=1e-5)  # as tests/test_pallas_bwd.py
THETA = 1e6
S = 128


def _ids(B, pattern):
    """Segment ids, positions and V2PE ids of B rows of S tokens.

    'packed': row 0 holds three segments and a padded tail, with positions
    restarting per segment and fractional (image-like) V2PE ids; row 1 is
    all padding (every query attends nothing). 'one': one segment, arange.
    """
    seg = np.ones((B, S), np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if pattern == "packed":
        seg[:] = 0
        seg[0, :50], seg[0, 50:90], seg[0, 90:118] = 1, 2, 3
        pos[0] = np.concatenate([np.arange(50), np.arange(40),
                                 np.arange(28), np.zeros(10)])
    rope = pos.astype(np.float32)
    rope[:, 5:21] = 4 + 0.25 * np.arange(1, 17)
    return seg, pos, rope


def _inputs(B, Hq, Hkv, D, pattern, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    seg, pos, rope = _ids(B, pattern)
    return q, k, v, do, seg, pos, rope


CASES = {  # name: (causal, Hq, Hkv, D, pattern, rope: None | 'q' | 'qk')
    "causal_packed_G2_d64": (True, 4, 2, 64, "packed", None),
    "bidir_G1_d64": (False, 2, 2, 64, "one", None),
    "causal_positions_G4_d128": (True, 8, 2, 128, "packed", None),
    "causal_qrope_G2_d128": (True, 4, 2, 128, "packed", "q"),
    "bidir_qkrope_G1_d64": (False, 2, 2, 64, "packed", "qk"),
    "causal_qkrope_G4_d64_empty_segment": (True, 8, 2, 64, "packed", "qk"),
}


def _case(name):
    causal, Hq, Hkv, D, pattern, rope = CASES[name]
    q, k, v, do, seg, pos, ids = _inputs(2, Hq, Hkv, D, pattern)
    seg_k = seg.copy()
    if name.endswith("empty_segment"):
        seg_k[0, 90:118] = 4  # the queries of segment 3 see no key
    rope_q = ids if rope else None
    rope_k = ids if rope == "qk" else None
    statics = jattn.AttnStatics(causal=causal, scale=D ** -0.5, block_q=64,
                                block_k=64, impl="jnp", ordered=False,
                                rope_theta=THETA if rope else 0.0)
    out, lse = jattn._fwd_dispatch(
        statics, *map(jnp.asarray, (q, k, v, seg, seg_k, pos, pos)),
        None if rope_q is None else jnp.asarray(rope_q),
        None if rope_k is None else jnp.asarray(rope_k))
    return statics, (q, k, v, seg, seg_k, pos, pos, np.asarray(out),
                     np.asarray(lse), do), rope_q, rope_k


def _torch_bwd(statics, rope_q, rope_k):
    def fn(*a):
        return flash_bwd.flash_attention_bwd(
            *a, causal=statics.causal, scale=statics.scale,
            rope_q=None if rope_q is None else torch.from_numpy(rope_q),
            rope_k=None if rope_k is None else torch.from_numpy(rope_k),
            rope_theta=statics.rope_theta)
    return fn


def _opt(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_twin_matches_pallas_interpret(name):
    statics, args, rope_q, rope_k = _case(name)

    def jax_fn(*a):
        return flash_attention_bwd_pallas(
            *a, causal=statics.causal, scale=statics.scale, block_q=64,
            block_k=64, ordered=False, interpret=True, rope_q=_opt(rope_q),
            rope_k=_opt(rope_k), rope_theta=statics.rope_theta)

    p = run_parity(jax_fn, _torch_bwd(statics, rope_q, rope_k), *args)
    p.assert_close(**TOL)
    assert all(np.isfinite(t).all() for t in p.torch)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_twin_matches_jnp(name):
    statics, args, rope_q, rope_k = _case(name)

    def jax_fn(*a):
        return jattn._bwd_dispatch(statics, *a, _opt(rope_q), _opt(rope_k))

    p = run_parity(jax_fn, _torch_bwd(statics, rope_q, rope_k), *args)
    p.assert_close(**TOL)


def test_bwd_twin_zero_on_rows_that_attend_nothing():
    statics, args, _, _ = _case("causal_packed_G2_d64")
    dq, dk, dv = flash_bwd.flash_attention_bwd(
        *(torch.from_numpy(np.array(a)) for a in args), causal=True, scale=statics.scale)
    seg = args[3]
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
        assert (g[torch.from_numpy(seg == 0)] == 0).all()


def test_rope_transpose_matches_jax():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2, S, 3, 64)).astype(np.float32)
    _, _, ids = _ids(2, "packed")
    p = run_parity(lambda g, r: jattn._rope_transpose(g, r, THETA),
                   lambda g, r: rope_transpose(g, r, THETA), g, ids)
    p.assert_close(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("rope", [None, "q"])
@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_flash_attention_grad_matches_jax(rope, impl):
    """d/d(q, k, v) of sum(sin(out)) over live rows: the port's autograd
    Function against jax.grad through JAX's custom_vjp (jnp, and the Pallas
    kernels in interpret mode)."""
    q, k, v, _, seg, pos, ids = _inputs(2, 4, 2, 64, "packed", seed=5)
    live = seg != 0

    def jax_fn(q, k, v, seg, pos, ids, live):
        def loss(q, k, v):
            o = jattn.flash_attention(
                q, k, v, q_segment_ids=seg, kv_segment_ids=seg,
                q_positions=pos, kv_positions=pos, causal=True, impl=impl,
                block_q=64, block_k=64,
                rope_positions=(ids, None, THETA) if rope else None)
            return jnp.sum(jnp.where(live[..., None, None], jnp.sin(o), 0.0))
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    def torch_fn(q, k, v, seg, pos, ids, live):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = tattn.flash_attention(
            q, k, v, q_segment_ids=seg, kv_segment_ids=seg, q_positions=pos,
            kv_positions=pos, causal=True,
            rope_positions=(ids, None, THETA) if rope else None)
        torch.where(live[..., None, None], torch.sin(o), 0.0).sum().backward()
        return q.grad, k.grad, v.grad

    p = run_parity(jax_fn, torch_fn, q, k, v, seg, pos, ids, live)
    p.assert_close(**TOL)


def test_decode_route_grad_is_plain_autograd():
    """A <=16-token query block over a longer sequence takes the grouped
    einsum, whose gradient is autograd's: it matches JAX's too."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 4, 4, 64)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 64)).astype(np.float32)
    qpos = np.arange(36, 40, dtype=np.int32)[None]
    kpos = np.arange(40, dtype=np.int32)[None]

    def jax_fn(q, k, v, qp, kp):
        return jax.grad(lambda q, k, v: jnp.sum(jattn.flash_attention(
            q, k, v, q_positions=qp, kv_positions=kp) ** 2),
            argnums=(0, 1, 2))(q, k, v)

    def torch_fn(q, k, v, qp, kp):
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        (tattn.flash_attention(q, k, v, q_positions=qp, kv_positions=kp)
         ** 2).sum().backward()
        return q.grad, k.grad, v.grad

    run_parity(jax_fn, torch_fn, q, k, v, qpos, kpos).assert_close(**TOL)


def test_unsupported_device_raises():
    t = torch.zeros(1, 64, 2, 64, device="meta")
    ids = torch.zeros(1, 64, dtype=torch.int32, device="meta")
    lse = torch.zeros(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no flash backward kernel"):
        flash_bwd.flash_attention_bwd(t, t, t, ids, ids, ids, ids, t, lse, t,
                                      causal=True, scale=0.125)
