"""Normalization layers (port of ``v2pe_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """InternLM2RMSNorm: fp32 variance and normalization, downcast to the
    input dtype, then multiply by the weight."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return weight * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm computed in fp32, then weight and bias in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mean) * (var + eps) ** -0.5
    return (xf.to(x.dtype) * weight + bias).to(x.dtype)
