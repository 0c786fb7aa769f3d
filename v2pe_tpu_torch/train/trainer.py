"""Training loop (port of ``v2pe_tpu/train/trainer.py``) on one device
or on every rank of a mesh: host-side packing in a background thread, the
train step, asynchronous checkpoints and resume with the data-iterator
state of the last CONSUMED batch.

Under a process group each rank packs the rows of its (data, fsdp)
coordinate (the caller shards the datasets by that coordinate, as the CLI
does), so the ranks of one ``seq`` or ``tensor`` line see the same batch;
each keeps its ``seq`` shard of the tokens (``make_global_batch``). Only
rank 0 logs and reports metrics."""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from v2pe_tpu_torch.core.config import MeshConfig, VLMConfig
from v2pe_tpu_torch.data.packing import PackedSampleIterator, collate_rows
from v2pe_tpu_torch.core import checkpoint as ckpt_lib
from v2pe_tpu_torch.parallel import context as pctx
from v2pe_tpu_torch.parallel.bootstrap import make_global_batch
from v2pe_tpu_torch.parallel.mesh import (place_lora, placement_of,
                                          shard_model)
from v2pe_tpu_torch.train.optimizer import (TrainConfig, build_optimizer,
                                            lr_schedule)
from v2pe_tpu_torch.train.train_step import make_train_step

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RunConfig:
    output_dir: str = "out"
    max_steps: int = 1000
    save_steps: int = 2500
    save_total_limit: int = 5
    log_steps: int = 10
    max_packed_tokens: int = 8192
    rows_per_batch: int = 1
    max_tiles: int = 32
    loss_reduction: str = "token"
    seed: int = 42


class Prefetcher:
    """Background host thread that packs + collates next batches.

    A batch that waits for room in the queue is kept until it is taken
    (the JAX loop's thread drops it after ``poll_s`` and packs the next
    one, which skips data whenever a step is slower than that)."""

    poll_s = 1.0  # how often a waiting put looks at the stop flag

    def __init__(self, make_batch: Callable[[], tuple], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = False
        self.make_batch = make_batch
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop:
            try:
                item = self.make_batch()
            except Exception as e:  # surface pipeline errors to the consumer
                self.q.put(e)
                return
            while not self._stop:
                try:
                    self.q.put(item, timeout=self.poll_s)
                    break
                except queue.Full:
                    continue

    def next(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def stop(self, timeout: float = 60.0):
        """Stop and join the thread (it finishes the batch it is making),
        so it no longer reads the datasets once the loop has returned."""
        self._stop = True
        self.thread.join(timeout)


def _dp_generator(seed: int, step: int, device) -> torch.Generator:
    """The DropPath stream of one step (the JAX loop folds the step into a
    base key; torch's generators draw other numbers in any case)."""
    return torch.Generator(device=device).manual_seed(
        ((seed ^ 0x5EED) << 32) + step)


def train(cfg: VLMConfig, model: nn.Module, packer: PackedSampleIterator,
          run: RunConfig, tc: TrainConfig, *,
          mesh_cfg: Optional[MeshConfig] = None,
          img_context_token_id: int, resume: bool = True,
          pixel_dtype=np.float32,
          metrics_hook: Optional[Callable[[int, dict], None]] = None,
          pipe_microbatches: int = 0, ring_mode: str = "scan", remat=True,
          async_save: bool = True, use_backbone_lora: int = 0,
          use_llm_lora: int = 0, offload_optimizer: bool = False):
    """Run the training loop on the model's device; returns (model,
    opt_state, step). The model is trained in place.

    ``mesh_cfg.seq`` shards the sequence over ring attention (the batches
    are collated zigzag-permuted): on that one device in a process without
    a process group, where any other mesh axis above 1 raises
    ``NotImplementedError``; across ranks under one. ``mesh_cfg.pipe``
    cuts the decoder into stages, one a rank, run in
    ``pipe_microbatches`` GPipe microbatches (``parallel/pipeline.py``).
    Under a process group the model is placed on the mesh here unless it
    is already (``parallel/mesh.py:shard_model``). ``offload_optimizer``
    turns int8 Adam on and keeps its moments in pinned host memory
    (``train/adam8bit.py:Stager``); a resume restores them there.

    With ``use_backbone_lora`` / ``use_llm_lora`` > 0 (the ranks) the model
    stays frozen and only rank-r adapters train (``models/lora.py``,
    drawn from a generator seeded ``run.seed ^ 0x10BA``): checkpoints hold
    the adapters and their optimizer state only, resume restores the
    adapters, and the model returned is a new merged model (base +
    adapters, export-ready); the model passed in is left as it was. On a
    mesh the adapters are drawn on the whole model, then a frozen view of
    it and the adapters are placed (``parallel/mesh.py:place_lora``), then
    the optimizer is built over the adapters, JAX's order."""
    grouped = dist.is_initialized()
    mesh = mesh_cfg if mesh_cfg and (mesh_cfg.num_devices > 1 or grouped) \
        else None
    seq_shards = mesh_cfg.seq if mesh_cfg else 1
    ctx = None if mesh is None else pctx.ShardingContext.from_mesh(
        mesh, ring_mode=ring_mode, pipe_microbatches=pipe_microbatches)
    placed = ctx is not None and ctx.mesh is not None
    lead = not grouped or dist.get_rank() == 0  # logs and reports
    if offload_optimizer:
        tc = dataclasses.replace(tc, use_8bit_optimizer=True,
                                 offload_optimizer=True)
    device = next(model.parameters()).device
    lora_mode = bool(use_backbone_lora or use_llm_lora)
    trainable, forward = model, model
    if lora_mode:  # JAX's order: the adapters, then the placement
        from v2pe_tpu_torch.models.lora import build_lora

        if placed and placement_of(model) is not None:
            raise ValueError("LoRA on a mesh takes the whole base model")
        trainable = build_lora(
            torch.Generator(device=device).manual_seed(run.seed ^ 0x10BA),
            model, backbone_r=use_backbone_lora, llm_r=use_llm_lora)
        if placed:
            forward = place_lora(model, trainable, cfg, ctx)
    elif placed and placement_of(model) is None:
        shard_model(model, cfg, ctx)
    optimizer = build_optimizer(tc, trainable, cfg)
    opt_state = optimizer.init()
    step_fn = make_train_step(cfg, optimizer, mesh, img_context_token_id,
                              remat=remat,
                              pipe_microbatches=pipe_microbatches,
                              ring_mode=ring_mode, lora=lora_mode,
                              offload_optimizer=offload_optimizer)

    start_step = 0
    if resume:
        last = ckpt_lib.latest_checkpoint(run.output_dir)
        if last is not None:
            trainable, opt_state, start_step, data_state = \
                ckpt_lib.restore_checkpoint(last, trainable, opt_state)
            if data_state is not None:
                packer.load_state_dict(data_state)
            if lead:
                logger.info("resumed from %s at step %d", last, start_step)

    row_iter = iter(packer)

    def make_batch():
        rows = [next(row_iter) for _ in range(run.rows_per_batch)]
        # the packer state once THIS batch is consumed: saving
        # packer.state_dict() at checkpoint time would count samples
        # already pulled into prefetched batches and skip them on resume
        data_state = packer.state_dict()
        batch = collate_rows(
            rows, max_tokens=run.max_packed_tokens, max_tiles=run.max_tiles,
            img_context_token_id=img_context_token_id,
            num_image_token=cfg.num_image_token,
            loss_reduction=run.loss_reduction, seq_shards=seq_shards,
            pixel_dtype=pixel_dtype)
        batch.pop("statistics")
        return batch, data_state

    saver = ckpt_lib.AsyncSaver() if async_save else None
    prefetch = Prefetcher(make_batch)
    sched = lr_schedule(tc)
    t_last = time.time()
    tokens_since = 0
    use_dp = cfg.vision.drop_path_rate > 0.0
    try:
        for step in range(start_step, run.max_steps):
            batch, consumed_state = prefetch.next()
            batch = make_global_batch(batch, ctx, device)
            gen = _dp_generator(run.seed, step, device) if use_dp else None
            if lora_mode:
                loss, gnorm = step_fn(trainable, opt_state, batch, forward,
                                      gen)
            else:
                loss, gnorm = step_fn(model, opt_state, batch, gen)
            tokens_since += run.rows_per_batch * run.max_packed_tokens * (
                1 if ctx is None else ctx.dp_size)

            if (step + 1) % run.log_steps == 0 and lead:
                loss, gnorm = float(loss), float(gnorm)
                dt = time.time() - t_last
                tps = tokens_since / max(dt, 1e-9)
                logger.info(
                    "step %d loss %.4f grad_norm %.3f lr %.2e tok/s %.0f",
                    step + 1, loss, gnorm, sched(step + 1), tps)
                if metrics_hook:
                    metrics_hook(step + 1, {
                        "loss": loss, "tokens_per_sec": tps,
                        "grad_norm": gnorm})
                t_last = time.time()
                tokens_since = 0

            if (step + 1) % run.save_steps == 0 or step + 1 == run.max_steps:
                save = saver.save if saver is not None \
                    else ckpt_lib.save_checkpoint
                path = save(run.output_dir, step + 1, trainable, opt_state,
                            data_state=consumed_state,
                            save_total_limit=run.save_total_limit, cfg=cfg)
                if lead:
                    logger.info("saved %s", path)
    finally:
        prefetch.stop()
        if saver is not None:
            saver.close()
    if lora_mode:
        from v2pe_tpu_torch.models.lora import merge_lora, whole_lora

        model = merge_lora(model, whole_lora(trainable))
    return model, opt_state, run.max_steps
