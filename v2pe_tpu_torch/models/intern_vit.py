"""InternViT vision encoder (port of ``v2pe_tpu/models/intern_vit.py``).

Patch embed as unfold + matmul in (c, kh, kw) order (no conv, so no TF32
convolution on the card), a prepended CLS token and a learned absolute
position embedding, bicubic-resized (A = -0.75) to other grids. Pre-norm
layers with LayerScale, optional QK-RMSNorm over the flattened head dim,
exact-erf GELU and bidirectional flash attention.

Training: DropPath (stochastic depth) on each residual branch with the
``linspace(0, drop_path_rate, L)`` schedule, and per-layer remat through
``torch.utils.checkpoint``. The keep masks are drawn from an explicit
``torch.Generator`` before the layers run, so a rematerialized layer sees
the same mask in its recomputation (``checkpoint`` restores the global RNG
streams, not an explicit generator's).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from v2pe_tpu_torch.core.config import VisionConfig
from v2pe_tpu_torch.ops.attention import flash_attention
from v2pe_tpu_torch.ops.norms import layer_norm, rms_norm
from v2pe_tpu_torch.parallel import context as parallel_context
from v2pe_tpu_torch.parallel.mesh import (column_input, is_split, row_linear,
                                          tensor_sum)


def _cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    at = t.abs()
    near = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1
    far = a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a
    return torch.where(at <= 1.0, near,
                       torch.where(at < 2.0, far, torch.zeros_like(at)))


def _bicubic_resize_1d_weights(in_size: int, out_size: int,
                               device=None) -> torch.Tensor:
    """(out, in) matrix of bicubic interpolation (align_corners=False, edge
    taps clamped)."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * scale - 0.5
    taps = src.floor()[:, None] + torch.arange(-1, 3, dtype=torch.float32,
                                               device=device)[None, :]
    weights = _cubic_kernel(src[:, None] - taps)
    idx = taps.clamp(0, in_size - 1).long()
    mat = torch.zeros((out_size, in_size), dtype=torch.float32, device=device)
    return mat.scatter_add_(1, idx, weights)


def interpolate_pos_embed(pos_embed: torch.Tensor, src: int, dst_h: int,
                          dst_w: int) -> torch.Tensor:
    """Bicubic-resize a (1, src*src, D) grid embedding to (1, dst_h*dst_w, D)
    in fp32."""
    D = pos_embed.shape[-1]
    grid = pos_embed.float().reshape(src, src, D)
    wh = _bicubic_resize_1d_weights(src, dst_h, grid.device)
    ww = _bicubic_resize_1d_weights(src, dst_w, grid.device)
    out = torch.einsum("hs,swd->hwd", wh, grid)
    out = torch.einsum("wt,htd->hwd", ww, out)
    return out.reshape(1, dst_h * dst_w, D)


class VisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        D, P, C = cfg.hidden_size, cfg.patch_size, cfg.num_channels
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.patch = nn.Linear(C * P * P, D)  # weight (D, C*P*P), (c,kh,kw)
        self.position_embedding = nn.Parameter(
            torch.zeros(1, cfg.num_patches_per_side ** 2 + 1, D))


def embeddings_forward(emb: VisionEmbeddings, cfg: VisionConfig,
                       pixel_values: torch.Tensor) -> torch.Tensor:
    """pixel_values (B, 3, H, W) -> (B, 1 + N, D)."""
    B, C, H, W = pixel_values.shape
    P = cfg.patch_size
    h, w = H // P, W // P
    dtype = emb.patch.weight.dtype
    x = pixel_values.to(dtype).reshape(B, C, h, P, w, P)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, h * w, C * P * P)
    patch = F.linear(x, emb.patch.weight) + emb.patch.bias
    cls = emb.class_embedding.to(dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, patch], dim=1)

    pos = emb.position_embedding
    src = int(round((pos.shape[1] - 1) ** 0.5))
    grid = pos[:, 1:] if (h, w) == (src, src) else \
        interpolate_pos_embed(pos[:, 1:], src, h, w)
    pos_full = torch.cat([pos[:, :1].float(), grid.float()], dim=1)
    return x + pos_full.to(dtype)


class VisionLayer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        D, I = cfg.hidden_size, cfg.intermediate_size
        self.norm1 = nn.Parameter(torch.ones(D))
        self.norm2 = nn.Parameter(torch.ones(D))
        if cfg.norm_type == "layer_norm":
            self.norm1_bias = nn.Parameter(torch.zeros(D))
            self.norm2_bias = nn.Parameter(torch.zeros(D))
        self.ls1 = nn.Parameter(torch.ones(D))
        self.ls2 = nn.Parameter(torch.ones(D))
        self.qkv = nn.Linear(D, 3 * D, bias=cfg.qkv_bias)
        if cfg.qk_normalization:
            self.q_norm = nn.Parameter(torch.ones(D))
            self.k_norm = nn.Parameter(torch.ones(D))
        self.proj = nn.Linear(D, D)
        self.fc1 = nn.Linear(D, I)
        self.fc2 = nn.Linear(I, D)

    def forward(self, cfg: VisionConfig, x, keep=None, masks=None):
        """:func:`layer_forward` through the module's call, so that the
        hooks of a sharded layer (FSDP2) run around it."""
        return layer_forward(self, cfg, x, keep, masks)


def _norm(cfg: VisionConfig, x, w, b):
    if cfg.norm_type == "rms_norm":
        return rms_norm(x, w, cfg.layer_norm_eps)
    return layer_norm(x, w, b, cfg.layer_norm_eps)


def _split_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
                    width: int) -> torch.Tensor:
    """``rms_norm`` over a dimension of ``width`` whose slices lie on the
    tensor ranks: the mean of squares is summed across them."""
    xf = x.float()
    var = tensor_sum((xf * xf).sum(dim=-1, keepdim=True)) / width
    return weight * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _attention(p: VisionLayer, cfg: VisionConfig, x: torch.Tensor):
    B, N, D = x.shape
    hd = cfg.head_dim
    # under a tensor axis the layer holds whole heads of each of q, k and v
    # and the matching columns of proj (parallel/mesh.py)
    split = is_split(p.proj, D)
    H = p.proj.in_features // hd
    qkv = p.qkv(column_input(x, split)).reshape(B, N, 3, H, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.qk_normalization:
        # RMSNorm over the flattened (H * hd) dim, not per head
        def norm(t, w):
            t = t.reshape(B, N, H * hd)
            t = _split_rms_norm(t, w, cfg.layer_norm_eps, D) if split \
                else rms_norm(t, w, cfg.layer_norm_eps)
            return t.reshape(B, N, H, hd)

        q, k = norm(q, p.q_norm), norm(k, p.k_norm)
    out = flash_attention(q, k, v, causal=False).reshape(B, N, H * hd)
    return row_linear(out, p.proj, split)


def _mlp(p: VisionLayer, cfg: VisionConfig, x: torch.Tensor) -> torch.Tensor:
    split = is_split(p.fc2, cfg.intermediate_size)
    h = F.gelu(p.fc1(column_input(x, split)), approximate="none")
    return row_linear(h, p.fc2, split)


def drop_path(x: torch.Tensor, keep: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Stochastic depth on a residual branch (timm DropPath semantics):
    sample b of x is kept, scaled by 1/keep, where ``mask[b]`` is True and
    zeroed elsewhere. ``keep`` = 1 - rate, a float32 scalar tensor."""
    m = mask.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(m, x.float() / keep, 0.0).to(x.dtype)


def drop_path_masks(cfg: VisionConfig, num_layers: int, batch: int,
                    generator: torch.Generator, device=None):
    """(keep (L,) float32, masks (L, 2, batch) bool): the per-layer keep
    probabilities of the schedule linspace(0, rate, num_hidden_layers) and
    the Bernoulli(keep) masks of each layer's two branches, drawn from
    ``generator`` (which must live on ``device``)."""
    rate = torch.linspace(0.0, cfg.drop_path_rate, cfg.num_hidden_layers,
                          dtype=torch.float32, device=device)[:num_layers]
    keep = 1.0 - rate
    u = torch.rand((num_layers, 2, batch), generator=generator,
                   device=device)
    return keep, u < keep[:, None, None]


def layer_forward(p: VisionLayer, cfg: VisionConfig, x: torch.Tensor,
                  keep: Optional[torch.Tensor] = None,
                  masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm + LayerScale residual block; with ``keep`` and ``masks``
    (2, B), each residual branch goes through DropPath."""
    h = _norm(cfg, x, p.norm1, getattr(p, "norm1_bias", None))
    branch = _attention(p, cfg, h) * p.ls1
    if masks is not None:
        branch = drop_path(branch, keep, masks[0])
    x = x + branch
    h = _norm(cfg, x, p.norm2, getattr(p, "norm2_bias", None))
    branch = _mlp(p, cfg, h) * p.ls2
    if masks is not None:
        branch = drop_path(branch, keep, masks[1])
    return x + branch


class InternVisionModel(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.embeddings = VisionEmbeddings(cfg)
        self.layers = nn.ModuleList(
            VisionLayer(cfg) for _ in range(cfg.num_hidden_layers))


def vision_forward(model: InternVisionModel, cfg: VisionConfig,
                   pixel_values: torch.Tensor, *,
                   select_layer: int = -1, remat: bool = False,
                   drop_path_generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """(B, 1 + N, D) hidden states after the selected layer (-1 = last,
    -4 = three layers early).

    remat: checkpoint each layer (its input is the only residual).
    drop_path_generator: during training, enables DropPath when
    ``cfg.drop_path_rate > 0``; None keeps the layers deterministic."""
    x = embeddings_forward(model.embeddings, cfg, pixel_values)
    num_layers = cfg.num_hidden_layers
    if select_layer != -1:
        num_layers = num_layers + 1 + select_layer
        if not 0 < num_layers <= cfg.num_hidden_layers:
            raise ValueError(f"select_layer {select_layer} out of range")
    keep = masks = None
    if drop_path_generator is not None and cfg.drop_path_rate > 0.0:
        # the masks of the global batch, as JAX draws them from one key:
        # under a mesh this rank's tiles are the rows of its (data, fsdp)
        # coordinate, and every coordinate holds as many
        ctx = parallel_context.current()
        at, count = (0, 1) if ctx is None else (ctx.dp_index, ctx.dp_size)
        T = x.shape[0]
        keep, masks = drop_path_masks(cfg, num_layers, T * count,
                                      drop_path_generator, x.device)
        masks = masks[:, :, at * T:(at + 1) * T]
    remat = remat and torch.is_grad_enabled()
    for i, layer in enumerate(model.layers[:num_layers]):
        dp = () if masks is None else (keep[i], masks[i])
        # the module's call: a sharded layer's hooks run around it
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, cfg, x, *dp,
                                                  use_reentrant=False)
        else:
            x = layer(cfg, x, *dp)
    return x
