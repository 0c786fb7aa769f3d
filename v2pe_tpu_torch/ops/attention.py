"""Segment-aware flash attention, port of ``v2pe_tpu/ops/attention.py``'s
``flash_attention`` (with its ``custom_vjp``) and
``flash_attention_with_lse``.

Routing as in the JAX package: a query block of at most 16 tokens over a
longer key sequence (decode) goes to the grouped einsum of
``attention_reference`` (plain autograd); everything else goes to the flash
kernel (``ops/flash_fwd.py``: the CUDA kernel on the card, its twin on the
CPU) inside :class:`_Flash`, whose backward is the flash backward
(``ops/flash_bwd.py``): when a gradient is needed it saves the
pre-rotation q and k, the ids, out and lse, as ``_flash_fwd`` does.

Layout: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); segment ids (B, S) int32 with
0 = padding; positions (B, S) int32.
"""

from __future__ import annotations

from typing import Optional

import torch

from v2pe_tpu_torch.ops.attention_ref import attention_reference
from v2pe_tpu_torch.ops.flash_bwd import flash_attention_bwd
from v2pe_tpu_torch.ops.flash_fwd import _apply_rope, flash_attention_fwd


def _arange(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _ones(B: int, S: int, device) -> torch.Tensor:
    return torch.ones((B, S), dtype=torch.int32, device=device)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


class _Flash(torch.autograd.Function):
    """Counterpart of ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``: the
    forward kernel, then the backward kernels on its residuals."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q, rope_k,
                causal: bool, scale: float, theta: float):
        out, lse = flash_attention_fwd(
            q, k, v, seg_q, seg_k, pos_q, pos_k, causal=causal, scale=scale,
            rope_q=rope_q, rope_k=rope_k, rope_theta=theta)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q,
                              rope_k, out, lse)
        ctx.statics = (causal, scale, theta)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_k, pos_q, pos_k, rope_q, rope_k, out, lse = \
            ctx.saved_tensors
        causal, scale, theta = ctx.statics
        dq, dk, dv = flash_attention_bwd(
            q, k, v, seg_q, seg_k, pos_q, pos_k, out, lse,
            do.to(q.dtype).contiguous(), causal=causal, scale=scale,
            rope_q=rope_q, rope_k=rope_k, rope_theta=theta)
        return (dq, dk, dv) + (None,) * 9


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    causal: bool = True, scale: Optional[float] = None,
                    rope_positions=None) -> torch.Tensor:
    """Segment-aware attention, (B, Sq, Hq, D) in q's dtype.

    Segment ids default to one segment, positions to arange.
    rope_positions = (rope_q (B,Sq) f32, rope_k (B,Sk) f32 or None, theta):
    q (and k if rope_k is given) arrive unrotated and the V2PE rotary is
    applied inside the kernel."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert k.shape == v.shape and Hq % Hkv == 0
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    if q_segment_ids is None:
        q_segment_ids = _ones(B, Sq, dev)
    if kv_segment_ids is None:
        kv_segment_ids = _ones(B, Sk, dev)
    if q_positions is None:
        q_positions = _arange(B, Sq, dev)
    if kv_positions is None:
        kv_positions = _arange(B, Sk, dev)
    rope_q = rope_k = None
    theta = 0.0
    if rope_positions is not None:
        rope_q, rope_k, theta = rope_positions
        rope_q = rope_q.float().contiguous()
        if rope_k is not None:
            rope_k = rope_k.float().contiguous()

    # decode: a <=16-token query block would leave the kernel's 64-row tiles
    # mostly empty; the grouped einsum reads the keys once
    if Sq <= 16 and Sk > Sq:
        if theta:
            q, k = _apply_rope(q, k, rope_q, rope_k, theta)
        return attention_reference(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, causal=causal, scale=scale,
            q_positions=q_positions, kv_positions=kv_positions)

    return _Flash.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), _i32(q_segment_ids),
        _i32(kv_segment_ids), _i32(q_positions), _i32(kv_positions), rope_q,
        rope_k, causal, float(scale), float(theta))


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             q_segment_ids: Optional[torch.Tensor] = None,
                             kv_segment_ids: Optional[torch.Tensor] = None,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """Forward flash attention returning (out, lse (B, Hq, Sq) fp32), with
    arange positions — what a logsumexp merge of two partial attentions
    needs. Forward only, as in JAX."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    if q_segment_ids is None:
        q_segment_ids = _ones(B, Sq, dev)
    if kv_segment_ids is None:
        kv_segment_ids = _ones(B, Sk, dev)
    return flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), _i32(q_segment_ids),
        _i32(kv_segment_ids), _i32(_arange(B, Sq, dev)),
        _i32(_arange(B, Sk, dev)), causal=causal, scale=float(scale))
