"""Rotary position embedding from V2PE's per-token float32 position ids.

Port of ``v2pe_tpu/ops/rope.py``: cos/sin are computed per call from an
arbitrary float32 position vector (fractional for visual tokens), and the
rotation runs in fp32 before casting back to the input dtype.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

Base = Union[float, torch.Tensor]


def rope_inv_freq(head_dim: int, base: Base,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """inv_freq = base^(-2i/dim), float32."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (base ** (i / head_dim))


def compute_rope_cos_sin(pos_ids: torch.Tensor, head_dim: int, base: Base):
    """(cos, sin), each (..., S, head_dim) float32, in the half-duplicated
    ``cat(freqs, freqs)`` layout."""
    inv_freq = rope_inv_freq(head_dim, base, pos_ids.device)
    freqs = pos_ids.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate (..., S, H, D) or (..., S, D) states in fp32, return x's dtype.
    cos/sin are (..., S, D) and broadcast over a head axis when x has one."""
    xf = x.float()
    if x.ndim == cos.ndim + 1:
        cos, sin = cos[..., :, None, :], sin[..., :, None, :]
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def rope_transpose(g: torch.Tensor, rope: torch.Tensor,
                   theta: Base) -> torch.Tensor:
    """Rᵀ for the rotation R = cos·I + sin·rot_half (rot_halfᵀ = -rot_half):
    maps a gradient with respect to rotated (B, S, H, D) states back to the
    states before rotation, in fp32, returned in g's dtype."""
    cos, sin = compute_rope_cos_sin(rope, g.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]
    gf = g.float()
    return (gf * cos - _rotate_half(gf) * sin).to(g.dtype)


def scale_positions(pos_ids: torch.Tensor, head_dim: int, base: float, *,
                    mode: str = "v2pe", scaling_factor: float = 1.0,
                    max_position_embeddings: int = 32768,
                    seq_len: Optional[int] = None):
    """RoPE-scaling modes: 'v2pe'/'default' pass through, 'linear' divides
    positions by the factor, 'dynamic' (NTK) rescales the base once the
    total context ``seq_len`` exceeds ``max_position_embeddings``.

    Returns (scaled positions, effective base); the base is a Python float
    except in 'dynamic' mode, where it is a 0-d float32 tensor."""
    if mode in ("v2pe", "default"):
        return pos_ids, base
    if mode == "linear":
        return pos_ids / scaling_factor, base
    if mode == "dynamic":
        s = seq_len if seq_len is not None else pos_ids.shape[-1]
        s = torch.tensor(float(s), dtype=torch.float32, device=pos_ids.device)
        scaled = base * ((scaling_factor * s / max_position_embeddings)
                         - (scaling_factor - 1)) ** (head_dim / (head_dim - 2))
        base = torch.where(s > max_position_embeddings, scaled,
                           torch.tensor(base, dtype=torch.float32,
                                        device=pos_ids.device))
        return pos_ids, base
    raise NotImplementedError(mode)
