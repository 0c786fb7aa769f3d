"""Forward flash attention: the CUDA kernel's wrapper and its plain twin.

Port of ``v2pe_tpu/ops/flash_pallas.py:flash_attention_fwd_pallas``. The
kernel is ``csrc/flash_fwd.cu`` (built by ``ops/_build.py``); its plain
PyTorch twin, :func:`flash_attention_fwd_torch`, has the same contract.

Contract (the JAX layouts):
  q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), Hq % Hkv == 0, q head h reads kv
  head h // (Hq // Hkv); seg_q/seg_k (B, S) int32 with 0 = padding;
  pos_q/pos_k (B, S) int32. A query attends a key iff both carry the same
  nonzero segment and, if causal, pos_q >= pos_k.
  rope_theta > 0: q (and k, when rope_k is given) arrive unrotated and get
  the V2PE rotary from the (B, S) float32 ids rope_q/rope_k.
  Returns out (B, Sq, Hq, D) in q's dtype and lse (B, Hq, Sq) float32; a
  row with nothing to attend gives out = 0 and lse = -1e30.

:func:`flash_attention_fwd` runs the twin for tensors on the CPU and the
kernel for tensors on a CUDA device; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from v2pe_tpu_torch.ops.rope import (apply_rotary, compute_rope_cos_sin,
                                     rope_inv_freq)

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
TWIN_BLOCK_Q = 512  # query rows per step of the twin

# Kernel launches since the last reset: the smoke run zeroes it, drives the
# serving path, and reads how often that path went through the kernel.
LAUNCHES = 0


def _apply_rope(q, k, rope_q, rope_k, theta):
    """Rotate q (and k when rope_k is given), as the JAX jnp path does."""
    cos, sin = compute_rope_cos_sin(rope_q, q.shape[-1], theta)
    q = apply_rotary(q, cos, sin)
    if rope_k is not None:
        cos, sin = compute_rope_cos_sin(rope_k, k.shape[-1], theta)
        k = apply_rotary(k, cos, sin)
    return q, k


def flash_attention_fwd_torch(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                              causal: bool, scale: float,
                              rope_q: Optional[torch.Tensor] = None,
                              rope_k: Optional[torch.Tensor] = None,
                              rope_theta: float = 0.0):
    """Plain PyTorch twin of the kernel: exact fp32 softmax over all keys,
    blocked over queries to bound the (Hq, TWIN_BLOCK_Q, Sk) score
    buffer."""
    if rope_theta:
        q, k = _apply_rope(q, k, rope_q, rope_k, rope_theta)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    for s0 in range(0, Sq, TWIN_BLOCK_Q):
        s1 = min(s0 + TWIN_BLOCK_Q, Sq)
        qb = (q[:, s0:s1].float() * scale).reshape(B, s1 - s0, Hkv, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf)
        sq = seg_q[:, s0:s1, None]
        mask = (sq == seg_k[:, None, :]) & (sq != 0)
        if causal:
            mask &= pos_q[:, s0:s1, None] >= pos_k[:, None, :]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        # clamping the max above NEG_INF/2 makes masked scores underflow
        # to exactly 0, as in the kernel's online softmax
        m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2)
        e = torch.exp(s - m)
        l = e.sum(dim=-1, keepdim=True)
        l_safe = torch.where(l > 0, l, 1.0)
        o = torch.einsum("bhgqk,bkhd->bqhgd", e / l_safe, vf)
        out[:, s0:s1] = o.reshape(B, s1 - s0, Hq, D).to(q.dtype)
        lse[:, :, s0:s1] = torch.where(l > 0, m + torch.log(l_safe),
                                       NEG_INF).reshape(B, Hq, s1 - s0)
    return out, lse


def _check(q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q, rope_k):
    B, Sq, Hq, D = q.shape
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {HEAD_DIMS}, got {D}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[2] != 0:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         f"for q {tuple(q.shape)}")
    Sk = k.shape[1]
    vecs = [(seg_q, Sq, torch.int32), (pos_q, Sq, torch.int32),
            (seg_k, Sk, torch.int32), (pos_k, Sk, torch.int32)]
    if rope_q is not None:
        vecs.append((rope_q, Sq, torch.float32))
    if rope_k is not None:
        vecs.append((rope_k, Sk, torch.float32))
    for t, S, dt in vecs:
        if t.shape != (B, S) or t.dtype != dt:
            raise ValueError(f"expected a ({B}, {S}) {dt} vector, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in [q, k, v] + [t for t, _, _ in vecs]:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash kernel takes contiguous tensors")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def flash_attention_fwd(q, k, v, seg_q, seg_k, pos_q, pos_k, *,
                        causal: bool, scale: float,
                        rope_q: Optional[torch.Tensor] = None,
                        rope_k: Optional[torch.Tensor] = None,
                        rope_theta: float = 0.0):
    """Forward flash attention (see the module docstring for the contract).

    CPU tensors go to the twin; CUDA tensors go to the kernel, after a
    check that raises on what the kernel does not take."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_fwd_torch(
            q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal, scale=scale,
            rope_q=rope_q, rope_k=rope_k, rope_theta=rope_theta)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if not rope_theta:
        rope_q = rope_k = None
    elif rope_q is None:
        raise ValueError("rope_theta > 0 needs rope_q")
    _check(q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q, rope_k)
    from v2pe_tpu_torch.ops import _build

    lib = _build.load()
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    # the rotary's inverse frequencies come from the same function as the
    # twin's, so kernel and twin rotate by identical fp32 angles
    inv_freq = rope_inv_freq(D, rope_theta, q.device) if rope_theta else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.v2pe_flash_fwd(
        _ptr(q), _ptr(k), _ptr(v), _ptr(seg_q), _ptr(seg_k), _ptr(pos_q),
        _ptr(pos_k), _ptr(rope_q), _ptr(rope_k), _ptr(inv_freq),
        _ptr(out), _ptr(lse), B, Sq, Sk, Hq, Hkv, D,
        int(q.dtype == torch.bfloat16), int(causal), float(scale),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out, lse
