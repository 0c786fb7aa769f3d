"""Reference O(S^2)-memory attention (port of
``v2pe_tpu/ops/attention_ref.py``): fp32 softmax, grouped GQA, masking by
segment ids (0 = padding) and positions.

Layout: q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D); segment ids (B, S) int32.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _index(n: int, offset, device) -> torch.Tensor:
    return torch.arange(n, device=device) + offset


def make_attention_mask(q_segment_ids: torch.Tensor,
                        kv_segment_ids: torch.Tensor, *, causal: bool,
                        q_offset=0, kv_offset=0,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Boolean (B, Sq, Sk) mask, True = attend: same nonzero segment and,
    if causal, query position >= key position."""
    seg_q = q_segment_ids[:, :, None]
    seg_k = kv_segment_ids[:, None, :]
    mask = (seg_q == seg_k) & (seg_q != 0)
    if causal:
        dev = q_segment_ids.device
        q_idx = q_positions[:, :, None] if q_positions is not None else \
            _index(q_segment_ids.shape[-1], q_offset, dev)[None, :, None]
        k_idx = kv_positions[:, None, :] if kv_positions is not None else \
            _index(kv_segment_ids.shape[-1], kv_offset, dev)[None, None, :]
        mask = mask & (q_idx >= k_idx)
    return mask


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_segment_ids: Optional[torch.Tensor] = None,
                        kv_segment_ids: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None,
                        q_offset=0, kv_offset=0,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Full-materialization attention; q head h*G+g reads kv head h.

    As in the JAX reference, a row with no key to attend softmaxes a row of
    NEG_INF scores into uniform weights (the flash kernels emit 0 there)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    assert Hq % Hkv == 0
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    bf16 = k.dtype == torch.bfloat16
    # bf16 operands are rounded as the JAX einsum sees them; the products
    # are accumulated in fp32 either way
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    if bf16:
        qf = qf.to(torch.bfloat16).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    scores = scores.reshape(B, Hq, Sq, Sk)

    if q_segment_ids is not None:
        mask = make_attention_mask(
            q_segment_ids, kv_segment_ids, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset, q_positions=q_positions,
            kv_positions=kv_positions)
        scores = torch.where(mask[:, None], scores, NEG_INF)
    elif causal:
        dev = q.device
        q_idx = q_positions[0][:, None] if q_positions is not None else \
            _index(Sq, q_offset, dev)[:, None]
        k_idx = kv_positions[0][None, :] if kv_positions is not None else \
            _index(Sk, kv_offset, dev)[None, :]
        scores = torch.where(q_idx >= k_idx, scores, NEG_INF)

    weights = torch.softmax(scores, dim=-1).reshape(B, Hkv, G, Sq, Sk)
    if v.dtype == torch.bfloat16:
        weights = weights.to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)
