"""InternVLChat composite model (port of
``v2pe_tpu/models/internvl_chat.py``): ViT features, pixel shuffle and the
``mlp1`` projector, scattered into the ``<IMG_CONTEXT>`` slots of the text
embeddings, then the InternLM2 decoder to fp32 logits."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from v2pe_tpu.core.config import VLMConfig
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.intern_vit import InternVisionModel, vision_forward
from v2pe_tpu_torch.ops.norms import layer_norm


class Projector(nn.Module):
    """mlp1: LayerNorm -> Linear -> GELU -> Linear."""

    def __init__(self, vit_hidden: int, llm_hidden: int):
        super().__init__()
        self.ln_weight = nn.Parameter(torch.ones(vit_hidden))
        self.ln_bias = nn.Parameter(torch.zeros(vit_hidden))
        self.fc1 = nn.Linear(vit_hidden, llm_hidden)
        self.fc2 = nn.Linear(llm_hidden, llm_hidden)


class InternVLChatModel(nn.Module):
    def __init__(self, cfg: VLMConfig):
        super().__init__()
        self.vision = InternVisionModel(cfg.vision)
        self.llm = internlm2.InternLM2Model(cfg.llm)
        vit_hidden = cfg.vision.hidden_size * int(1 / cfg.downsample_ratio) ** 2
        self.mlp1 = Projector(vit_hidden, cfg.llm.hidden_size)


def pixel_shuffle(x: torch.Tensor, scale_factor: float,
                  ps_version: str = "v2") -> torch.Tensor:
    """(N, W, H, C) -> (N, W*s, H*s, C/s^2), including the transposed v1."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale_factor), int(c / scale_factor))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale_factor), int(w * scale_factor),
                  int(c / (scale_factor * scale_factor)))
    if ps_version == "v2":
        x = x.permute(0, 2, 1, 3)
    return x


def extract_feature(model: InternVLChatModel, cfg: VLMConfig,
                    pixel_values: torch.Tensor) -> torch.Tensor:
    """(N_tiles, 3, S, S) -> (N_tiles, num_image_token, llm_hidden)."""
    vit = vision_forward(model.vision, cfg.vision, pixel_values,
                         select_layer=cfg.select_layer)[:, 1:]  # drop CLS
    n, num_patches, c = vit.shape
    hw = int(round(num_patches ** 0.5))
    vit = pixel_shuffle(vit.reshape(n, hw, hw, c), cfg.downsample_ratio,
                        cfg.ps_version)
    vit = vit.reshape(n, -1, vit.shape[-1])

    p = model.mlp1
    h = layer_norm(vit, p.ln_weight, p.ln_bias, 1e-5)
    h = p.fc2(F.gelu(p.fc1(h), approximate="none"))

    if cfg.img_emb_down_sample_ratio is not None:
        # adaptive 1-D average pool along tokens: bucket i covers
        # [floor(i*N/t), ceil((i+1)*N/t))
        tgt, n_tok = cfg.num_image_token, h.shape[1]
        i = torch.arange(tgt, device=h.device)
        starts = (i * n_tok) // tgt
        ends = -(-((i + 1) * n_tok) // tgt)
        idx = torch.arange(n_tok, device=h.device)
        win = ((idx[None] >= starts[:, None]) &
               (idx[None] < ends[:, None])).float()
        win = win / win.sum(dim=1, keepdim=True)
        h = torch.einsum("tn,bnc->btc", win, h.float()).to(h.dtype)
    return h


def scatter_image_embeds_by_index(input_embeds: torch.Tensor,
                                  vit_embeds: torch.Tensor,
                                  vit_gather_idx: torch.Tensor
                                  ) -> torch.Tensor:
    """vit_gather_idx (B, S): the flat ViT row feeding each slot, -1 for a
    text token."""
    C = input_embeds.shape[-1]
    flat = vit_embeds.reshape(-1, C)
    gathered = flat[vit_gather_idx.clamp(0, flat.shape[0] - 1)]
    return torch.where((vit_gather_idx >= 0)[..., None], gathered,
                       input_embeds)


def scatter_image_embeds(input_embeds: torch.Tensor, input_ids: torch.Tensor,
                         vit_embeds: torch.Tensor, image_flags: torch.Tensor,
                         img_context_token_id: int) -> torch.Tensor:
    """The j-th <IMG_CONTEXT> token (flat batch x seq order) takes row j of
    the ViT rows of real tiles (image_flags == 1, stable-sorted first)."""
    B, S, C = input_embeds.shape
    flat = vit_embeds.reshape(-1, C)
    flag_rows = image_flags.to(torch.int32).repeat_interleave(
        vit_embeds.shape[1])
    flat_sorted = flat[torch.argsort(1 - flag_rows, stable=True)]
    selected = (input_ids == img_context_token_id).reshape(-1)
    idx = (torch.cumsum(selected.to(torch.int64), 0) - 1).clamp(
        0, flat_sorted.shape[0] - 1)
    gathered = flat_sorted[idx].reshape(B, S, C)
    return torch.where(selected.reshape(B, S, 1), gathered, input_embeds)


class VLMOutput(NamedTuple):
    logits: torch.Tensor


def forward(model: InternVLChatModel, cfg: VLMConfig, *,
            input_ids: torch.Tensor, pixel_values: torch.Tensor,
            image_flags: torch.Tensor, rope_pos_ids: torch.Tensor,
            img_context_token_id: int,
            segment_ids: Optional[torch.Tensor] = None,
            token_positions: Optional[torch.Tensor] = None,
            vit_gather_idx: Optional[torch.Tensor] = None) -> VLMOutput:
    """Logits path of the packed multimodal forward: fp32 (B, S, V)."""
    embeds = model.llm.tok_embeddings(input_ids)
    vit = extract_feature(model, cfg, pixel_values)
    if vit_gather_idx is not None:
        embeds = scatter_image_embeds_by_index(embeds, vit, vit_gather_idx)
    else:
        embeds = scatter_image_embeds(embeds, input_ids, vit, image_flags,
                                      img_context_token_id)
    logits, _ = internlm2.llm_forward(
        model.llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
        segment_ids=segment_ids, positions=token_positions)
    return VLMOutput(logits=logits)
