"""A mixture-of-experts layer: DeepSeek-V3's router, the routed experts as
grouped products, and the combine.

No TPU kernel of the JAX package computes it (the JAX package has no
experts). The layer runs in the order of the published
``DeepseekV3MoE`` (``transformers/models/deepseek_v3``), without its loop
over experts:

* :func:`route`: float32 logits of the (E, D) gate, sigmoid scores, the
  ``num_experts_per_tok`` experts of the highest score plus correction
  bias (the bias only selects; one group, ``n_group`` = ``topk_group`` =
  1, as Kimi-VL publishes: ``core/config`` refuses others), their scores
  normalised to sum to 1 when ``norm_topk_prob``, then scaled by
  ``routed_scaling_factor``;
* :func:`experts`: the N x k (token, expert) pairs sorted by expert
  (stable, so a token keeps its order inside its expert), each expert's
  rows one group of a grouped product, ``torch._grouped_mm`` with the
  group ends (offsets) kept on the device: one launch a projection for
  all the experts, no token dropped, nothing read back; the SwiGLU in the
  weights' dtype; each pair's output weighted in float32, put back in
  token order and summed over its k experts in a fixed order;
* the shared experts, one dense SwiGLU, added after.

On the card the grouped products are PyTorch's own grouped GEMM (bf16),
as the dense layers' products are ``F.linear``; on the CPU the same call
takes float32 too.

Counters: ``counts`` (3,) int64 on the device, when given, accumulates
the layer's (token, expert) pairs, the experts with at least one token,
and the tokens of the busiest expert; nothing is read back here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, *,
          top_k: int, norm_topk_prob: bool = True, scaling: float = 1.0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) tokens -> (experts (N, k) int64, weights (N, k) float32)."""
    scores = F.linear(x.float(), gate.float()).sigmoid()
    choice = scores + bias.float()[None]
    idx = torch.topk(choice, top_k, dim=-1, sorted=False)[1]
    w = scores.gather(1, idx)
    if norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * scaling


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor):
    """Rows of ``x`` in groups ending at ``offs``, group e times w[e]^T
    (w: (E, out, in), ``nn.Linear``'s layout)."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=offs)


def experts(x: torch.Tensor, idx: torch.Tensor, weights: torch.Tensor,
            w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
            counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum_j weights[n, j] * expert_{idx[n, j]}(x[n]) for (N, D) tokens, in
    x's dtype. w1, w3: (E, I, D); w2: (E, D, I)."""
    N, k = idx.shape
    E = w1.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # a scatter, not bincount, which reads its input's max back
    load = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    offs = torch.cumsum(load, 0, dtype=torch.int32)
    xs = x[order // k]
    h = F.silu(_grouped(xs, w1, offs)) * _grouped(xs, w3, offs)
    y = _grouped(h, w2, offs).float() * weights.reshape(-1)[order, None]
    out = torch.empty_like(y)
    out[order] = y
    if counts is not None:
        counts[0].add_(N * k)
        counts[1:].add_(torch.stack([(load > 0).sum(), load.max()]))
    return out.view(N, k, -1).sum(1).to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """w2(silu(w1 x) * w3 x), weights in ``nn.Linear``'s layout."""
    return F.linear(F.silu(F.linear(x, w1)) * F.linear(x, w3), w2)
