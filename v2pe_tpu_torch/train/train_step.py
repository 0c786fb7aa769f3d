"""The training step (port of ``v2pe_tpu/train/train_step.py``) on one
device: loss, backward, optimizer update in place.

Batch contract (tensors on the model's device; ``data/packing.py`` and
``train/synth.py`` make it in numpy):
  input_ids (B,S) i32 | rope_pos_ids (B,S) f32 | token_positions (B,S) i32
  segment_ids (B,S) i32 | targets (B,S) i32 (pre-shifted, -100 ignore)
  loss_weight (B,S) f32 | pixel_values (T,3,sz,sz) | image_flags (T,) i32
  vit_gather_idx (B,S) i32 (-1 = text token)

A mesh, LoRA, pipeline microbatches, the fused ring and the offloaded
optimizer raise ``NotImplementedError``: they need the multi-card port.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2pe_tpu.core.config import VLMConfig
from v2pe_tpu_torch.models import internvl_chat
from v2pe_tpu_torch.train.optimizer import Optimizer


def loss_fn(model: nn.Module, cfg: VLMConfig, batch: dict,
            img_context_token_id: int, remat=True,
            drop_path_generator: Optional[torch.Generator] = None):
    """The weighted CE of one packed batch (the denominator is the batch's
    own weight sum)."""
    return internvl_chat.forward(
        model, cfg, input_ids=batch["input_ids"],
        pixel_values=batch["pixel_values"],
        image_flags=batch["image_flags"],
        rope_pos_ids=batch["rope_pos_ids"],
        img_context_token_id=img_context_token_id,
        segment_ids=batch["segment_ids"],
        token_positions=batch["token_positions"],
        vit_gather_idx=batch.get("vit_gather_idx"),
        targets=batch["targets"], loss_weight=batch["loss_weight"],
        remat=remat, drop_path_generator=drop_path_generator).loss


def make_train_step(cfg: VLMConfig, optimizer: Optimizer, mesh=None,
                    img_context_token_id: int = 0, remat=True,
                    pipe_microbatches: int = 0, ring_mode: str = "scan",
                    lora: bool = False, offload_optimizer: bool = False):
    """Returns ``step(model, opt_state, batch, drop_path_generator=None) ->
    (loss, grad_norm)``: the model's parameters and ``opt_state`` are
    updated in place; grad_norm is the global norm of the raw gradients."""
    for flag, what in ((mesh is not None, "a mesh"), (lora, "LoRA"),
                       (pipe_microbatches, "pipeline microbatches"),
                       (ring_mode != "scan", f"ring_mode={ring_mode!r}"),
                       (offload_optimizer, "the offloaded optimizer")):
        if flag:
            raise NotImplementedError(f"{what} is not ported (one device)")

    def step(model, opt_state, batch, drop_path_generator=None):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = loss_fn(model, cfg, batch, img_context_token_id, remat,
                       drop_path_generator)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        gnorm = optimizer.step(grads, opt_state)
        for p in params.values():
            p.grad = None
        return loss.detach(), gnorm

    return step
