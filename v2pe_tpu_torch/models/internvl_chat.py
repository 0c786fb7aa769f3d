"""InternVLChat composite model (port of
``v2pe_tpu/models/internvl_chat.py``): ViT features, pixel shuffle and the
``mlp1`` projector, scattered into the ``<IMG_CONTEXT>`` slots of the text
embeddings, then the InternLM2 decoder to fp32 logits; with ``targets``,
the weighted cross-entropy of training, computed in sequence chunks so that
at most one (chunk, V) fp32 logits block is live."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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
                    pixel_values: torch.Tensor, *, remat: bool = False,
                    drop_path_generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """(N_tiles, 3, S, S) -> (N_tiles, num_image_token, llm_hidden)."""
    vit = vision_forward(model.vision, cfg.vision, pixel_values,
                         select_layer=cfg.select_layer, remat=remat,
                         drop_path_generator=drop_path_generator
                         )[:, 1:]  # drop CLS
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
    loss: Optional[torch.Tensor]
    logits: Optional[torch.Tensor]


def forward(model: InternVLChatModel, cfg: VLMConfig, *,
            input_ids: torch.Tensor, pixel_values: torch.Tensor,
            image_flags: torch.Tensor, rope_pos_ids: torch.Tensor,
            img_context_token_id: int,
            segment_ids: Optional[torch.Tensor] = None,
            token_positions: Optional[torch.Tensor] = None,
            vit_gather_idx: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None,
            targets: Optional[torch.Tensor] = None,
            loss_weight: Optional[torch.Tensor] = None,
            loss_weight_sum: Optional[torch.Tensor] = None,
            remat=False,
            drop_path_generator: Optional[torch.Generator] = None
            ) -> VLMOutput:
    """The packed multimodal forward. With ``targets`` (pre-shifted labels,
    -100 = ignore) it returns the chunked weighted CE and no logits (the
    training path); otherwise fp32 (B, S, V) logits, and the shifted CE of
    ``labels`` when they are given. ``remat`` is the decoder's remat mode;
    the ViT checkpoints per layer whenever it is set."""
    if targets is not None and cfg.compress_seq:
        raise NotImplementedError("compress-seq training is not ported")
    embeds = model.llm.tok_embeddings(input_ids)
    vit = extract_feature(model, cfg, pixel_values, remat=bool(remat),
                          drop_path_generator=drop_path_generator)
    if vit_gather_idx is not None:
        embeds = scatter_image_embeds_by_index(embeds, vit, vit_gather_idx)
    else:
        embeds = scatter_image_embeds(embeds, input_ids, vit, image_flags,
                                      img_context_token_id)
    out, _ = internlm2.llm_forward(
        model.llm, cfg.llm, inputs_embeds=embeds, rope_pos_ids=rope_pos_ids,
        segment_ids=segment_ids, positions=token_positions, remat=remat,
        return_hidden=targets is not None)
    if targets is not None:
        loss = chunked_cross_entropy(out, model.llm.output.weight, targets,
                                     loss_weight, loss_weight_sum)
        return VLMOutput(loss=loss, logits=None)
    loss = None
    if labels is not None:
        loss = cross_entropy_loss(out, labels, loss_weight, loss_weight_sum)
    return VLMOutput(loss=loss, logits=out)


def _token_loss(logits: torch.Tensor, targets: torch.Tensor):
    """(-log p(target), valid) per position of fp32 logits (..., V)."""
    valid = targets != -100
    safe = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tl = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, tl, 0.0), valid


def _ce_block(h, output_weight, t, w):
    """(sum of weighted token losses, sum of weights) of one block."""
    tl, valid = _token_loss(F.linear(h.float(), output_weight), t)
    wv = w.float() * valid
    return (tl * wv).sum(), wv.sum()


def chunked_cross_entropy(hidden: torch.Tensor, output_weight: torch.Tensor,
                          targets: torch.Tensor,
                          loss_weight: Optional[torch.Tensor] = None,
                          loss_weight_sum: Optional[torch.Tensor] = None,
                          chunk: int = 2048) -> torch.Tensor:
    """Weighted CE of pre-shifted targets from the final hidden states
    (B, S, D) and the (V, D) head, per sequence chunk of ``chunk`` rows
    (halved until it divides S). Each chunk's projection and log-softmax
    run under ``torch.utils.checkpoint``, so the backward recomputes them
    and at most one (chunk, V) fp32 logits block is live."""
    B, S, _ = hidden.shape
    c = min(chunk, S)
    while S % c:
        c //= 2
    w = loss_weight if loss_weight is not None else \
        torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    wf = output_weight.float()  # fp32 products of the (bf16) operands
    if c == S:
        num, den = _ce_block(hidden, wf, targets, w)
    else:
        num = den = 0.0
        for s0 in range(0, S, c):
            sl = slice(s0, s0 + c)
            n, d = torch.utils.checkpoint.checkpoint(
                _ce_block, hidden[:, sl], wf, targets[:, sl], w[:, sl],
                use_reentrant=False)
            num, den = num + n, den + d
    wsum = loss_weight_sum if loss_weight_sum is not None else den
    return num / torch.clamp(torch.as_tensor(wsum, dtype=torch.float32,
                                             device=hidden.device), min=1e-8)


def _reduce(token_loss, valid, loss_weight, loss_weight_sum):
    if loss_weight is not None:
        w = loss_weight.float() * valid
        wsum = loss_weight_sum if loss_weight_sum is not None else w.sum()
        return (token_loss * w).sum() / torch.clamp(
            torch.as_tensor(wsum, dtype=torch.float32,
                            device=token_loss.device), min=1e-8)
    return token_loss.sum() / torch.clamp(valid.sum(), min=1)


def cross_entropy_loss_preshifted(logits, targets, loss_weight=None,
                                  loss_weight_sum=None) -> torch.Tensor:
    """CE against pre-shifted targets (targets[t] is the label of position
    t + 1), weighted when ``loss_weight`` is given."""
    tl, valid = _token_loss(logits, targets)
    return _reduce(tl, valid, loss_weight, loss_weight_sum)


def cross_entropy_loss(logits, labels, loss_weight=None,
                       loss_weight_sum=None) -> torch.Tensor:
    """Shifted CE (logits[:, :-1] against labels[:, 1:]) with optional
    per-token weights; ``loss_weight_sum`` replaces the local weight sum."""
    tl, valid = _token_loss(logits[:, :-1], labels[:, 1:])
    w = None if loss_weight is None else loss_weight[:, 1:]
    return _reduce(tl, valid, w, loss_weight_sum)
