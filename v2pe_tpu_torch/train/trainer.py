"""Training loop (port of ``v2pe_tpu/train/trainer.py``) on one device:
host-side packing in a background thread, the train step, asynchronous
checkpoints and resume with the data-iterator state of the last CONSUMED
batch."""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from v2pe_tpu.core.config import MeshConfig, VLMConfig
from v2pe_tpu.data.packing import PackedSampleIterator, collate_rows
from v2pe_tpu_torch.core import checkpoint as ckpt_lib
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

    A mesh of more than one device, LoRA and the offloaded optimizer raise
    ``NotImplementedError``."""
    if mesh_cfg is not None and mesh_cfg.num_devices > 1:
        raise NotImplementedError("a multi-device mesh is not ported")
    if use_backbone_lora or use_llm_lora:
        raise NotImplementedError("LoRA training is not ported")
    if offload_optimizer:
        tc = dataclasses.replace(tc, use_8bit_optimizer=True,
                                 offload_optimizer=True)
    device = next(model.parameters()).device
    optimizer = build_optimizer(tc, model, cfg)
    opt_state = optimizer.init()
    step_fn = make_train_step(cfg, optimizer, None, img_context_token_id,
                              remat=remat,
                              pipe_microbatches=pipe_microbatches,
                              ring_mode=ring_mode,
                              offload_optimizer=offload_optimizer)

    start_step = 0
    if resume:
        last = ckpt_lib.latest_checkpoint(run.output_dir)
        if last is not None:
            model, opt_state, start_step, data_state = \
                ckpt_lib.restore_checkpoint(last, model, opt_state)
            if data_state is not None:
                packer.load_state_dict(data_state)
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
            loss_reduction=run.loss_reduction, pixel_dtype=pixel_dtype)
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
            batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                     for k, v in batch.items()}
            gen = _dp_generator(run.seed, step, device) if use_dp else None
            loss, gnorm = step_fn(model, opt_state, batch, gen)
            tokens_since += run.rows_per_batch * run.max_packed_tokens

            if (step + 1) % run.log_steps == 0:
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
                path = save(run.output_dir, step + 1, model, opt_state,
                            data_state=consumed_state,
                            save_total_limit=run.save_total_limit, cfg=cfg)
                logger.info("saved %s", path)
    finally:
        prefetch.stop()
        if saver is not None:
            saver.close()
    return model, opt_state, run.max_steps
