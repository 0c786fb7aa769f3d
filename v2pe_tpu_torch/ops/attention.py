"""Segment-aware flash attention (forward), port of
``v2pe_tpu/ops/attention.py``'s ``flash_attention`` and
``flash_attention_with_lse``.

Routing as in the JAX package: a query block of at most 16 tokens over a
longer key sequence (decode) goes to the grouped einsum of
``attention_reference``; everything else goes to the flash kernel
(``ops/flash_fwd.py``: the CUDA kernel on the card, its twin on the CPU).
No autograd yet: the backward kernels come with training.

Layout: q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); segment ids (B, S) int32 with
0 = padding; positions (B, S) int32.
"""

from __future__ import annotations

from typing import Optional

import torch

from v2pe_tpu_torch.ops.attention_ref import attention_reference
from v2pe_tpu_torch.ops.flash_fwd import _apply_rope, flash_attention_fwd


def _arange(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _ones(B: int, S: int, device) -> torch.Tensor:
    return torch.ones((B, S), dtype=torch.int32, device=device)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


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

    out, _ = flash_attention_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(), _i32(q_segment_ids),
        _i32(kv_segment_ids), _i32(q_positions), _i32(kv_positions),
        causal=causal, scale=float(scale), rope_q=rope_q, rope_k=rope_k,
        rope_theta=float(theta))
    return out


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *,
                             q_segment_ids: Optional[torch.Tensor] = None,
                             kv_segment_ids: Optional[torch.Tensor] = None,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """Forward flash attention returning (out, lse (B, Hq, Sq) fp32), with
    arange positions — what a logsumexp merge of two partial attentions
    needs."""
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
