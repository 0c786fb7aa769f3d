"""Optimizer: AdamW (or int8 Adam) with a warmup + cosine schedule, no decay
for norms / biases / LayerScale, layer-wise lr decay, per-tower lr scales
and freeze flags (port of ``v2pe_tpu/train/optimizer.py``).

Plain tensor code over the port's parameters that runs optax's chain in
its order, per step:

  1. freeze mask (frozen gradients are 0 before anything sees them);
  2. clip by the global norm of all gradients together;
  3. Adam, or int8 Adam (``train/adam8bit.py``);
  4. decoupled weight decay on the decay mask;
  5. per-parameter lr scale, layer-wise decay as a per-layer factor;
  6. the lr schedule, read at the count BEFORE its increment (with warmup,
     the first update is zero);
  7. freeze mask again.

``grad_accum_steps > 1`` accumulates the running mean of the gradients and
updates every k-th call, as ``optax.MultiSteps``. Not ``torch.optim.AdamW``:
its step order and schedule counting differ.

The optimizer takes the model it trains, or the adapters of a LoRA run
(``models/lora.py``): every mask and scale is decided on the JAX leaf a
tensor belongs to, its path and its stacked ndim (``jax_leaf_map``, or
``lora_leaf_map`` for adapters, whose paths end in ``/a`` and ``/b``), as
the JAX chain decides it on the parameter or the adapter tree. So the
freeze flags also zero the adapters of a frozen tower, as in the JAX
package.

Dtypes: the Adam moments are kept in the parameters' dtype (optax's
``mu_dtype=None``); the arithmetic runs in fp32 and the update is added to
the parameter in fp32, then cast back (``optax.apply_updates``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.models.lora import LoRA, lora_leaf_map
from v2pe_tpu_torch.models.params import JaxLeaf, jax_leaf_map
from v2pe_tpu_torch.train import adam8bit


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields and defaults of ``v2pe_tpu.train.optimizer.TrainConfig``
    (which imports jax and optax, so it cannot be shared)."""

    learning_rate: float = 4e-5
    min_lr_ratio: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 20_000
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    vit_lr_scale: float = 1.0
    vit_layer_decay_rate: float = 1.0
    llm_layer_decay_rate: float = 1.0
    layer_scale_lr_scale: float = 1.0
    grad_accum_steps: int = 1
    use_8bit_optimizer: bool = False
    offload_optimizer: bool = False
    freeze_llm: bool = False
    freeze_backbone: bool = False
    freeze_mlp: bool = False
    unfreeze_lm_head: bool = False
    unfreeze_vit_layers: int = 0


def _path_str(leaf: JaxLeaf) -> str:
    return "/".join(leaf.path)


def _jax_ndim(p: torch.Tensor, leaf: JaxLeaf) -> int:
    return p.ndim + (leaf.layer is not None)


def _stack_len(cfg: VLMConfig, path: str) -> int:
    return cfg.vision.num_hidden_layers if path.startswith("vision/") \
        else cfg.llm.num_hidden_layers


def _no_decay(path: str, ndim: int) -> bool:
    return (ndim <= 1 and not path.startswith("llm/tok_embeddings")) or \
        "norm" in path or path.endswith("ls1") or path.endswith("ls2") or \
        "bias" in path or path.startswith("compress/layer_scale")


def leaf_map(model: nn.Module, cfg: VLMConfig) -> Dict[str, JaxLeaf]:
    """The JAX leaves of what ``model`` trains: the parameters of the
    port's model, or the tensors of a LoRA adapter set."""
    if isinstance(model, LoRA):
        return lora_leaf_map(model)
    return jax_leaf_map(cfg, compress=getattr(model, "compress", None)
                        is not None)


def decay_mask(model: nn.Module, cfg: VLMConfig) -> Dict[str, bool]:
    """Parameter name -> whether weight decay applies (decided on the JAX
    leaf: its path and its stacked ndim)."""
    leaves = leaf_map(model, cfg)
    return {n: not _no_decay(_path_str(leaves[n]), _jax_ndim(p, leaves[n]))
            for n, p in model.named_parameters()}


def lr_scale_tree(cfg: VLMConfig, tc: TrainConfig,
                  leaves: Optional[Dict[str, JaxLeaf]] = None
                  ) -> Dict[str, float]:
    """Parameter name -> lr multiplier; layer i of a stack of L gets
    ``rate ** (L - 1 - i)`` on top (later layers a higher lr). ``leaves``:
    the tensors' JAX leaves (default: the model's parameters)."""
    out = {}
    for n, leaf in (leaves or jax_leaf_map(cfg)).items():
        p = _path_str(leaf)
        scale = np.float32(1.0)
        if p.startswith("vision/"):
            scale *= np.float32(tc.vit_lr_scale)
        if p.endswith("/ls1") or p.endswith("/ls2") or \
                p.startswith("compress/layer_scale"):
            scale *= np.float32(tc.layer_scale_lr_scale)
        rate = None
        if p.startswith("vision/layers/") and tc.vit_layer_decay_rate != 1.0:
            rate = tc.vit_layer_decay_rate
        if p.startswith("llm/layers/") and tc.llm_layer_decay_rate != 1.0:
            rate = tc.llm_layer_decay_rate
        if rate is not None and leaf.layer is not None:
            L = _stack_len(cfg, p)
            scale = scale * np.power(np.float32(rate),
                                     np.float32(L - 1 - leaf.layer))
        out[n] = float(np.float32(scale))
    return out


def freeze_mask_tree(cfg: VLMConfig, tc: TrainConfig,
                     leaves: Optional[Dict[str, JaxLeaf]] = None
                     ) -> Dict[str, float]:
    """Parameter name -> 1.0 (trains) or 0.0 (frozen), with the unfreeze
    carve-outs: the lm head under freeze_llm, and the last |n| ViT layers
    (``unfreeze_vit_layers`` = -n) under freeze_backbone. ``leaves`` as in
    :func:`lr_scale_tree`."""
    out = {}
    for n, leaf in (leaves or jax_leaf_map(cfg)).items():
        p = _path_str(leaf)
        trainable = 1.0
        if tc.freeze_backbone and p.startswith("vision/"):
            trainable = 0.0
        if tc.freeze_llm and p.startswith("llm/"):
            trainable = 0.0
        if tc.freeze_mlp and p.startswith("mlp1/"):
            trainable = 0.0
        if tc.unfreeze_lm_head and p == "llm/output_kernel":
            trainable = 1.0
        if (tc.unfreeze_vit_layers != 0 and p.startswith("vision/layers/")
                and leaf.layer is not None):
            L = _stack_len(cfg, p)
            start = tc.unfreeze_vit_layers % L \
                if tc.unfreeze_vit_layers < 0 else tc.unfreeze_vit_layers
            if leaf.layer >= start:
                trainable = 1.0
        out[n] = trainable
    return out


def _any_freeze(tc: TrainConfig) -> bool:
    return (tc.freeze_llm or tc.freeze_backbone or tc.freeze_mlp
            or tc.unfreeze_vit_layers != 0)


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), lr * min_lr_ratio)`` as a function of the step count,
    evaluated in float32."""
    peak = np.float32(tc.learning_rate)
    end = np.float32(tc.learning_rate * tc.min_lr_ratio)
    warm = tc.warmup_steps
    decay = max(tc.total_steps, tc.warmup_steps + 1) - warm
    alpha = np.float32(0.0 if tc.learning_rate == 0.0 else end / peak)

    def schedule(count: int) -> float:
        if count < warm:  # linear from 0 to peak over the warmup
            frac = np.float32(1) - np.float32(count) / np.float32(warm)
            return float((np.float32(0) - peak) * frac + peak)
        c = np.float32(min(count - warm, decay))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay)))
        return float(peak * ((np.float32(1) - alpha) * cos + alpha))

    return schedule


def _bias_correction(b: float, count: int) -> torch.Tensor:
    return 1 - torch.tensor(b, dtype=torch.float32) ** float(count)


def _jax_layout(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    return t.t() if transposed else t


class Optimizer:
    """The chain of ``build_optimizer`` over one model's parameters (or
    one LoRA adapter set's).

    ``init()`` gives the state (a dict of tensors and ints that
    ``torch.save`` takes); ``step(grads, state)`` applies one update to the
    parameters in place, advances the state in place and returns the
    gradients' global norm."""

    def __init__(self, tc: TrainConfig, model: nn.Module, cfg: VLMConfig):
        if tc.offload_optimizer:
            raise NotImplementedError(
                "offload_optimizer (int8 moments in host memory) is not "
                "ported")
        self.tc = tc
        self.params = dict(model.named_parameters())
        leaves = leaf_map(model, cfg)
        self.decay = decay_mask(model, cfg)
        self.scales = lr_scale_tree(cfg, tc, leaves)
        self.freeze = freeze_mask_tree(cfg, tc, leaves) \
            if _any_freeze(tc) else None
        self.schedule = lr_schedule(tc)
        self.leaves = leaves
        # int8 Adam: the parameters of each JAX leaf in stack order, and the
        # runs of them quantized together (one per layer when every layer
        # is a whole number of blocks, else the whole stacked leaf)
        groups: Dict[str, list] = {}
        for n in self.params:
            groups.setdefault(_path_str(leaves[n]), []).append(n)
        self.groups = {k: sorted(v, key=lambda n: leaves[n].layer or 0)
                       for k, v in groups.items()}

    def _segments(self, names):
        sizes = [self.params[n].numel() for n in names]
        if all(s % adam8bit.BLOCK == 0 for s in sizes):
            return [[n] for n in names]
        return [list(names)]

    def init(self) -> dict:
        state = {"count": 0, "lr_count": 0}
        if self.tc.use_8bit_optimizer:
            state["moments"] = {
                k: adam8bit.zeros(sum(self.params[n].numel() for n in names),
                                  self.params[names[0]].device)
                for k, names in self.groups.items()}
        else:
            state["mu"] = {n: torch.zeros_like(p)
                           for n, p in self.params.items()}
            state["nu"] = {n: torch.zeros_like(p)
                           for n, p in self.params.items()}
        if self.tc.grad_accum_steps > 1:
            state["mini_step"] = 0
            state["acc"] = {n: torch.zeros_like(p)
                            for n, p in self.params.items()}
        return state

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             state: dict) -> torch.Tensor:
        """One call of the chain; returns the global norm of ``grads`` (a
        0-dim fp32 tensor on their device, not synced)."""
        sq = _sums_of_squares(grads, self.params)
        norm = torch.sqrt(sum(sq.values()))
        k = self.tc.grad_accum_steps
        if k <= 1:
            self._update(grads, state, sq)
            return norm
        n_acc = state["mini_step"]
        for n, acc in state["acc"].items():  # running mean, as MultiSteps
            acc.copy_(acc + (grads[n] - acc) / (n_acc + 1))
        state["mini_step"] = (n_acc + 1) % k
        if n_acc == k - 1:
            self._update(state["acc"], state,
                         _sums_of_squares(state["acc"], self.params))
            for acc in state["acc"].values():
                acc.zero_()
        return norm

    def _update(self, grads: Dict[str, torch.Tensor], state: dict,
                sq: Dict[str, torch.Tensor]) -> None:
        tc = self.tc
        mask = self.freeze or {}

        def masked(n):
            g = grads[n].float()
            return g * mask[n] if n in mask else g

        # the clip's norm is over the masked gradients; a mask is 0 or 1,
        # so a leaf's masked sum of squares is its sum times its mask
        norm = torch.sqrt(sum(s * mask[n] if n in mask else s
                              for n, s in sq.items()))
        keep = norm < tc.max_grad_norm
        state["count"] += 1
        bc1 = _bias_correction(tc.beta1, state["count"])
        bc2 = _bias_correction(tc.beta2, state["count"])
        lr = self.schedule(state["lr_count"])
        state["lr_count"] += 1

        def prepared(n):  # optax's clip_by_global_norm, on the device
            g = masked(n)
            return torch.where(keep, g, g / norm * tc.max_grad_norm)

        def finish(n, u):
            p = self.params[n]
            if self.decay[n]:
                u = u + tc.weight_decay * p.float()
            u = u * self.scales[n] * -lr
            if n in mask:
                u = u * mask[n]
            p.copy_(p.float() + u)

        if not tc.use_8bit_optimizer:
            for n, p in self.params.items():
                g = prepared(n)
                mu, nu = state["mu"][n], state["nu"][n]
                mu.copy_((1 - tc.beta1) * g + tc.beta1 * mu.float())
                nu.copy_((1 - tc.beta2) * g * g + tc.beta2 * nu.float())
                u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2)
                                          + tc.eps)
                finish(n, u)
            return
        for key, names in self.groups.items():
            mom, offset = state["moments"][key], 0
            for seg in self._segments(names):
                tr = [self.leaves[n].transposed for n in seg]
                flat = torch.cat([_jax_layout(prepared(n), t).reshape(-1)
                                  for n, t in zip(seg, tr)])
                out = adam8bit.update(flat, mom, offset, b1=tc.beta1,
                                      b2=tc.beta2, eps=tc.eps, bc1=bc1,
                                      bc2=bc2)
                offset += flat.numel()
                at = 0
                for n, t in zip(seg, tr):
                    p = self.params[n]
                    shape = _jax_layout(p, t).shape
                    u = out[at:at + p.numel()].reshape(shape)
                    at += p.numel()
                    finish(n, _jax_layout(u, t))


def build_optimizer(tc: TrainConfig, model: nn.Module,
                    cfg: VLMConfig) -> Optimizer:
    return Optimizer(tc, model, cfg)


def _sums_of_squares(grads: Dict[str, torch.Tensor],
                     params: Dict[str, nn.Parameter]) -> Dict[str, torch.Tensor]:
    """Parameter name -> the fp32 sum of squares of its gradient."""
    return {n: grads[n].float().square().sum() for n in params}
