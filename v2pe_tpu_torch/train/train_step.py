"""The training step (port of ``v2pe_tpu/train/train_step.py``): loss,
backward, optimizer update in place, on one device or on every rank of a
mesh.

Batch contract (tensors on the model's device; ``data/packing.py`` and
``train/synth.py`` make it in numpy):
  input_ids (B,S) i32 | rope_pos_ids (B,S) f32 | token_positions (B,S) i32
  segment_ids (B,S) i32 | targets (B,S) i32 (pre-shifted, -100 ignore)
  loss_weight (B,S) f32 | pixel_values (T,3,sz,sz) | image_flags (T,) i32
  vit_gather_idx (B,S) i32 (-1 = text token)

``mesh`` is a ``MeshConfig``. In a process without a process group only
its ``seq`` axis may exceed 1: the sequence is sharded over ring attention
with every shard on the model's card (``ring_mode`` 'scan' or 'fused'; the
batch then arrives zigzag-permuted, as ``collate_rows(seq_shards=n)`` makes
it). Under a process group the mesh covers the world, one rank a card
(``parallel/context.py:from_mesh``); the model must be placed on it
(``init_vlm_params(..., mesh=ctx)``, ``parallel/mesh.py``) and every rank
passes its own batch (``parallel/bootstrap.py:make_global_batch``). The
step then takes the CE's denominator as the GLOBAL weight sum (all-reduced
over data, fsdp and seq; JAX's denominator is global under GSPMD), so the
loss is a sum of the ranks' shares: FSDP2 reduce-scatters the gradients as
sums over ``fsdp``, the step sums them over ``data`` and ``seq``, and the
loss it returns is the global one. On a ``pipe`` axis each rank holds its
stage's decoder layers and the layers run GPipe-pipelined in
``pipe_microbatches`` microbatches (``parallel/pipeline.py``; 0 lets
``choose_microbatches`` pick); the loss and the gradients of everything
outside the decoder layers come out the same on every pipe rank, and the
denominator is not summed over ``pipe``. ``offload_optimizer=True``
declares an optimizer built with ``TrainConfig(use_8bit_optimizer=True,
offload_optimizer=True)``: its int8 moments live in host memory and pass
through the card one segment at a time once the backward is done
(``train/adam8bit.py:Stager``), and the step returns once they are back.

``lora=True`` trains LoRA adapters (``models/lora.py``) over a frozen base
model, as the JAX step does: the forward runs on the merged weights of
``lora_view(base, adapters)`` and the gradients reach the adapters only;
the optimizer is built over the adapters. On a mesh the step takes the
view ``parallel/mesh.py:place_lora`` placed in place of the base, and the
adapters' gradients are summed as their placement says.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.parallel import context as pctx
from v2pe_tpu_torch.parallel.mesh import local, placement_of
from v2pe_tpu_torch.train.optimizer import Optimizer


def loss_fn(model: nn.Module, cfg: VLMConfig, batch: dict,
            img_context_token_id: int, remat=True,
            drop_path_generator: Optional[torch.Generator] = None,
            loss_weight_sum: Optional[torch.Tensor] = None):
    """The weighted CE of one packed batch (the denominator is the batch's
    own weight sum, or ``loss_weight_sum``). The model is called as a
    module, so that a sharded model's hooks run."""
    return model(
        cfg, input_ids=batch["input_ids"],
        pixel_values=batch["pixel_values"],
        image_flags=batch["image_flags"],
        rope_pos_ids=batch["rope_pos_ids"],
        img_context_token_id=img_context_token_id,
        segment_ids=batch["segment_ids"],
        token_positions=batch["token_positions"],
        vit_gather_idx=batch.get("vit_gather_idx"),
        targets=batch["targets"], loss_weight=batch["loss_weight"],
        loss_weight_sum=loss_weight_sum, remat=remat,
        drop_path_generator=drop_path_generator).loss


def global_weight_sum(ctx, batch: dict) -> torch.Tensor:
    """The CE's denominator over every rank's tokens: the weight of the
    valid targets, summed over data, fsdp and seq."""
    w = batch["loss_weight"].float() * (batch["targets"] != -100)
    return ctx.all_reduce(w.sum(), ("data", "fsdp", "seq"))


def make_train_step(cfg: VLMConfig, optimizer: Optimizer, mesh=None,
                    img_context_token_id: int = 0, remat=True,
                    pipe_microbatches: int = 0, ring_mode: str = "scan",
                    lora: bool = False, offload_optimizer: bool = False):
    """Returns ``step(model, opt_state, batch, drop_path_generator=None) ->
    (loss, grad_norm)``: the model's parameters and ``opt_state`` are
    updated in place; grad_norm is the global norm of the raw gradients.

    With ``lora=True`` the step is ``step(adapters, opt_state, batch, base,
    drop_path_generator=None)``: the adapters (a ``LoRA``) and
    ``opt_state`` are updated in place, the base model is only read; on a
    mesh ``base`` is the placed view (``place_lora``)."""
    if offload_optimizer:
        if lora:  # JAX asserts it
            raise ValueError("LoRA's optimizer state is rank-sized; "
                             "offloading it is pointless")
        if optimizer.stager is None:
            raise ValueError("offload_optimizer takes an optimizer built "
                             "with TrainConfig(offload_optimizer=True)")
    # unlike the JAX package off the TPU, 'fused' takes any remat mode: the
    # backward recomputes the fused forward like any other op
    ctx = None if mesh is None else pctx.ShardingContext.from_mesh(
        mesh, ring_mode=ring_mode, pipe_microbatches=pipe_microbatches)

    def update(trained, forward_model, opt_state, batch, gen):
        params = dict(trained.named_parameters())
        placement = placement_of(trained)
        if (ctx is not None and ctx.mesh is not None) != \
                (placement is not None) or (placement is not None and
                                            placement.ctx.mesh is not
                                            ctx.mesh):
            raise ValueError("the model must be placed on the step's mesh "
                             "(init_vlm_params / from_jax_params with "
                             "mesh=ShardingContext.from_mesh(...))")
        for p in params.values():
            p.grad = None
        with pctx.use_sharding(ctx):
            wsum = None if placement is None else \
                global_weight_sum(ctx, batch)
            loss = loss_fn(forward_model, cfg, batch, img_context_token_id,
                           remat, gen, wsum)
            loss.backward()
        grads = {n: local(p.grad) if p.grad is not None
                 else torch.zeros_like(local(p)) for n, p in params.items()}
        loss = loss.detach()
        if placement is not None:
            placement.reduce_grads(grads)
            loss = ctx.all_reduce(loss.clone(), ("data", "fsdp", "seq"))
        gnorm = optimizer.step(grads, opt_state)
        for p in params.values():
            p.grad = None
        return loss, gnorm

    if not lora:
        def step(model, opt_state, batch, drop_path_generator=None):
            return update(model, model, opt_state, batch,
                          drop_path_generator)

        return step
    from v2pe_tpu_torch.models.lora import lora_view

    views = {}

    def lora_step(adapters, opt_state, batch, base,
                  drop_path_generator=None):
        key = (id(base), id(adapters))
        if placement_of(base) is not None:  # placed with the adapters
            view = base
        else:
            if key not in views:  # the view aliases base's storage
                views.clear()
                views[key] = (lora_view(base, adapters), base, adapters)
            view = views[key][0]
        view.train(base.training)
        return update(adapters, view, opt_state, batch, drop_path_generator)

    return lora_step
