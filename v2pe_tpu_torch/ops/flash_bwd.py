"""Flash-attention backward: the CUDA kernels' wrapper and their plain twin.

Port of ``v2pe_tpu/ops/flash_pallas_bwd.py:flash_attention_bwd_pallas``.
Two kernels in ``csrc/flash_bwd.cu`` (built by ``ops/_build.py``) replace
the Pallas ``_dkv_kernel`` and ``_dq_kernel``; the plain PyTorch twin,
:func:`flash_attention_bwd_torch`, has the same contract.

Contract (the forward's layouts, ``ops/flash_fwd.py``):
  q/do/out (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), segment ids and positions
  (B, S) int32, lse (B, Hq, Sq) float32 from the forward. Probabilities are
  recomputed as exp(q·kᵀ·scale - lse) under the forward's mask; with
  di = rowsum(do·out) in fp32,
    dv = Σ pᵀ·do,  ds = p∘(do·vᵀ - di),  dk = Σ dsᵀ·q·scale,  dq = ds·k·scale,
  dk and dv summed over the Hq/Hkv query heads of a kv head's group.
  Returns (dq in q's dtype, dk in k's dtype, dv in v's dtype).
  rope_theta > 0: q and k are the residuals BEFORE rotation (the forward
  fuses the rotary). They are rotated here in torch at their own dtype, the
  kernels run on the rotated states, and dq (and dk, when rope_k is given)
  go back through Rᵀ; R is orthogonal, so this is exact.

:func:`flash_attention_bwd` runs the twin for tensors on the CPU and the
kernels for tensors on a CUDA device; it never falls back from one to the
other.
"""

from __future__ import annotations

from typing import Optional

import torch

from v2pe_tpu_torch.ops.flash_fwd import DTYPES, _apply_rope, _check, _ptr
from v2pe_tpu_torch.ops.rope import rope_transpose

TWIN_BLOCK_Q = 512  # query rows per step of the twin

# Kernel launches since the last reset, one count per kernel: the smoke run
# zeroes them, drives the training path, and reads how often it went
# through each.
LAUNCHES = {"flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def _rotated_bwd(bwd, q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse, do,
                 causal, scale, rope_q, rope_k, rope_theta):
    q, k = _apply_rope(q, k, rope_q, rope_k, rope_theta)
    dq, dk, dv = bwd(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse, do,
                     causal=causal, scale=scale)
    dq = rope_transpose(dq, rope_q, rope_theta)
    if rope_k is not None:
        dk = rope_transpose(dk, rope_k, rope_theta)
    return dq, dk, dv


def flash_attention_bwd_torch(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse,
                              do, *, causal: bool, scale: float,
                              rope_q: Optional[torch.Tensor] = None,
                              rope_k: Optional[torch.Tensor] = None,
                              rope_theta: float = 0.0):
    """Plain PyTorch twin of the kernels: exact fp32 over all keys, blocked
    over queries to bound the (Hq, TWIN_BLOCK_Q, Sk) buffers."""
    if rope_theta:
        return _rotated_bwd(flash_attention_bwd_torch, q, k, v, seg_q, seg_k,
                            pos_q, pos_k, out, lse, do, causal, scale,
                            rope_q, rope_k, rope_theta)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    kf, vf = k.float(), v.float()
    di = (out.float() * do.float()).sum(-1)  # (B, Sq, Hq)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for s0 in range(0, Sq, TWIN_BLOCK_Q):
        s1 = min(s0 + TWIN_BLOCK_Q, Sq)
        n = s1 - s0
        qb = (q[:, s0:s1].float() * scale).reshape(B, n, Hkv, G, D)
        dob = do[:, s0:s1].float().reshape(B, n, Hkv, G, D)
        lse_b = lse[:, :, s0:s1].reshape(B, Hkv, G, n, 1)
        di_b = di[:, s0:s1].reshape(B, n, Hkv, G).permute(0, 2, 3, 1)[..., None]
        sq = seg_q[:, s0:s1, None]
        mask = (sq == seg_k[:, None, :]) & (sq != 0)
        if causal:
            mask &= pos_q[:, s0:s1, None] >= pos_k[:, None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kf)
        # the mask selects, never multiplies: a row with nothing to attend
        # has lse = -1e30, where exp(s - lse) overflows to inf
        p = torch.where(mask[:, None, None], torch.exp(s - lse_b), 0.0)
        dv += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
        ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dob, vf) - di_b)
        dk += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb)
        dq[:, s0:s1] = (torch.einsum("bhgqk,bkhd->bqhgd", ds, kf) * scale
                        ).reshape(B, n, Hq, D).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _kernels_bwd(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse, do, *,
                 causal: bool, scale: float):
    """Launch the dkv and dq kernels on rotated (or unrotated) q/k."""
    from v2pe_tpu_torch.ops import _build

    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # di in fp32 outside the kernels, as the Pallas wrapper computes it
    di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    lib = _build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (_ptr(q), _ptr(k), _ptr(v), _ptr(do), _ptr(lse), _ptr(di),
            _ptr(seg_q), _ptr(seg_k), _ptr(pos_q), _ptr(pos_k))
    dims = (B, Sq, Sk, Hq, Hkv, D, int(q.dtype == torch.bfloat16),
            int(causal), float(scale), stream)
    for name, fn, outs in (("flash_bwd_dkv", lib.v2pe_flash_bwd_dkv,
                            (_ptr(dk), _ptr(dv))),
                           ("flash_bwd_dq", lib.v2pe_flash_bwd_dq,
                            (_ptr(dq),))):
        err = fn(*args, *outs, *dims)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        LAUNCHES[name] += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse, do,
                        *, causal: bool, scale: float,
                        rope_q: Optional[torch.Tensor] = None,
                        rope_k: Optional[torch.Tensor] = None,
                        rope_theta: float = 0.0):
    """(dq, dk, dv) of flash attention (see the module docstring).

    CPU tensors go to the twin; CUDA tensors go to the kernels, after a
    check that raises on what they do not take."""
    if q.device.type == "cpu":
        return flash_attention_bwd_torch(
            q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse, do, causal=causal,
            scale=scale, rope_q=rope_q, rope_k=rope_k, rope_theta=rope_theta)
    if q.device.type != "cuda":
        raise ValueError(f"no flash backward kernel for device {q.device}")
    if not rope_theta:
        rope_q = rope_k = None
    elif rope_q is None:
        raise ValueError("rope_theta > 0 needs rope_q")
    _check(q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q, rope_k)
    B, Sq, Hq, D = q.shape
    for name, t in (("out", out), ("do", do)):
        if t.shape != q.shape or t.dtype not in DTYPES \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32/bfloat16 "
                             f"{tuple(q.shape)} tensor on {q.device}")
    if do.dtype != q.dtype:
        raise ValueError(f"do is {do.dtype}, q is {q.dtype}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous ({B}, {Hq}, {Sq}) "
                         f"float32 tensor on {q.device}")
    if rope_theta:
        return _rotated_bwd(_kernels_bwd, q, k, v, seg_q, seg_k, pos_q,
                            pos_k, out, lse, do, causal, scale, rope_q,
                            rope_k, rope_theta)
    return _kernels_bwd(q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse, do,
                        causal=causal, scale=scale)
