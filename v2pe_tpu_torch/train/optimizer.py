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

On a mesh (a model placed by ``parallel/mesh.py:shard_model``) the
parameters are FSDP2 DTensors: the chain runs on each rank's local shards,
its moments are shards alike, and the global gradient norm sums each
shard's squares over ``fsdp`` and ``tensor``, a parameter whole on every
tensor rank counted once. Every mask and scale is elementwise, so the
update equals the single-device one.

int8 Adam's 256-value blocks run over each JAX leaf flattened in JAX's
layout, which a rank's shard is not a run of (a dim-0 shard of a torch
(out, in) weight is a set of columns of JAX's (in, out) kernel). Under
``fsdp`` or ``tensor`` each rank keeps the blocks its shard touches
(:class:`_Int8Shards`): a block it holds whole it updates alone; a block
cut between ranks has its prepared gradient summed into a buffer of the
cut blocks over the leaf's shard axes (each value sent by the one rank
that holds it) and updated by every rank that holds a part of it, so all
of them end with the codes and scales of one device.

``offload_optimizer`` (with int8 Adam only, as JAX asserts) keeps the int8
state in pinned host memory, each rank its own share, and stages it through
the card one segment at a time once every gradient exists
(``adam8bit.Stager``): the backward's peak holds no moments, the update's
holds two segments of them. The cut blocks still meet on the card.
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
from v2pe_tpu_torch.parallel.mesh import local, placement_of
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
        if tc.offload_optimizer and not tc.use_8bit_optimizer:
            raise ValueError("offload_optimizer requires use_8bit_optimizer "
                             "(the fp32 moment state has no per-leaf "
                             "staging path)")
        self.tc, self.cfg = tc, cfg
        self.params = dict(model.named_parameters())
        self.placement = placement_of(model)
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
        self.shards = None
        if tc.use_8bit_optimizer and self.placement is not None:
            self.shards = _Int8Shards(self)
            self.placement.moments = self.shards
        self.device = self._local(next(iter(self.params))).device
        self.stager = adam8bit.Stager(self.device) \
            if tc.offload_optimizer else None

    def _segments(self, names):
        """Runs of a leaf's layers updated together: a run ends where the
        blocks end, so that each starts on a block of its own."""
        out, run, at = [], [], 0
        for n in names:
            run.append(n)
            at += self._local(n).numel()
            if at % adam8bit.BLOCK == 0:
                out.append(run)
                run = []
        return out + ([run] if run else [])

    def _state_size(self, key: str) -> int:
        """Values of leaf ``key``'s int8 state on this rank: its shard's,
        or a whole block for each block the shard touches where one is
        cut."""
        plan = self.shards.plans.get(key) if self.shards else None
        if plan is not None and plan.src is not None:
            return plan.blocks.numel() * adam8bit.BLOCK
        return sum(self._local(n).numel() for n in self.groups[key])

    def _local(self, n: str) -> torch.Tensor:
        """This rank's shard of parameter ``n`` (the parameter itself off a
        mesh): fetched each time, FSDP2 may re-pad it at its first
        forward."""
        return local(self.params[n])

    def _total(self, per_param: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of per-parameter partial sums over the whole model."""
        if self.placement is not None:
            return self.placement.sum_of_shards(per_param)
        return sum(per_param.values())

    def init(self) -> dict:
        state = {"count": 0, "lr_count": 0}
        zeros = {n: torch.zeros_like(self._local(n)) for n in self.params}
        if self.tc.use_8bit_optimizer:
            host = self.stager is not None
            state["moments"] = {
                k: adam8bit.zeros(
                    self._state_size(k), "cpu" if host else self.device,
                    pin=host and self.device.type == "cuda")
                for k in self.groups}
        else:
            state["mu"] = zeros
            state["nu"] = {n: torch.zeros_like(z) for n, z in zeros.items()}
        if self.tc.grad_accum_steps > 1:
            state["mini_step"] = 0
            state["acc"] = {n: torch.zeros_like(z) for n, z in zeros.items()}
        return state

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             state: dict) -> torch.Tensor:
        """One call of the chain; returns the global norm of ``grads`` (a
        0-dim fp32 tensor on their device, not synced). On a mesh
        ``grads`` are each rank's shards, reduced over every axis."""
        sq = _sums_of_squares(grads, self.params)
        norm = torch.sqrt(self._total(sq))
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
        norm = torch.sqrt(self._total({n: s * mask[n] if n in mask else s
                                       for n, s in sq.items()}))
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
            p = self._local(n)
            if self.decay[n]:
                u = u + tc.weight_decay * p.float()
            u = u * self.scales[n] * -lr
            if n in mask:
                u = u * mask[n]
            p.copy_(p.float() + u)

        if not tc.use_8bit_optimizer:
            for n in self.params:
                g = prepared(n)
                mu, nu = state["mu"][n], state["nu"][n]
                mu.copy_((1 - tc.beta1) * g + tc.beta1 * mu.float())
                nu.copy_((1 - tc.beta2) * g * g + tc.beta2 * nu.float())
                u = (mu.float() / bc1) / (torch.sqrt(nu.float() / bc2)
                                          + tc.eps)
                finish(n, u)
            return
        adam = dict(b1=tc.beta1, b2=tc.beta2, eps=tc.eps, bc1=bc1, bc2=bc2)
        # the segments in update order: (parameters, state views, the
        # leaf's plan where its shard is not whole blocks, the plan whose
        # peers' cut blocks meet first where it is)
        jobs = []
        for key, names in self.groups.items():
            mom = state["moments"][key]
            plan = self.shards.plans.get(key) if self.shards else None
            if plan is not None and plan.src is not None:
                jobs.append((names, mom, plan, None))
                continue
            offset = 0
            for i, seg in enumerate(self._segments(names)):
                n = sum(self._local(x).numel() for x in seg)
                meet = plan if i == 0 and plan is not None and plan.cut \
                    else None
                jobs.append((seg, adam8bit.segment(mom, offset, n), None,
                             meet))
                offset += n

        def run(i, st):
            seg, _, plan, meet = jobs[i]
            if meet is not None:  # a collective; this rank sends nothing
                meet.meet(torch.empty(0, device=self.device))
            tr = [self.leaves[n].transposed for n in seg]
            flat = torch.cat([_jax_layout(prepared(n), t).reshape(-1)
                              for n, t in zip(seg, tr)])
            if plan is not None:
                out = plan.update(flat, st, adam)
            else:
                out = adam8bit.update(flat, st, 0, **adam) \
                    if flat.numel() else flat
            at = 0
            for n, t in zip(seg, tr):
                p = self._local(n)
                shape = _jax_layout(p, t).shape
                u = out[at:at + p.numel()].reshape(shape)
                at += p.numel()
                finish(n, _jax_layout(u, t))

        if self.stager is not None:
            self.stager.run([j[1] for j in jobs], run)
        else:
            for i, job in enumerate(jobs):
                run(i, job[1])


class _LeafPlan:
    """Where one JAX leaf's int8 blocks sit on this rank. ``blocks``: the
    leaf's blocks this rank's shard touches, ascending (the rows of its
    state). ``src`` is None where the shard is whole blocks in that order
    (its state is the shard's values in JAX order, updated in place);
    else, for each value of the rank's (blocks, BLOCK) state, where it
    comes from in ``[shard values | cut buffer | 0]``. ``cut``: the cut
    blocks of the leaf on any rank of its shard axes (the buffer's rows);
    ``send_from`` / ``send_to``: this rank's values in them."""

    def __init__(self, ctx, axes, numel, blocks, src, cut, send_from,
                 send_to):
        self.ctx, self.axes, self.numel = ctx, axes, numel
        self.blocks, self.src, self.cut = blocks, src, cut
        self.send_from, self.send_to = send_from, send_to

    def meet(self, flat: torch.Tensor) -> torch.Tensor:
        """The cut blocks whole on every rank of the shard axes (a sum in
        which each value comes from the one rank that holds it)."""
        buf = flat.new_zeros(self.cut * adam8bit.BLOCK)
        if self.send_from.numel():
            buf[self.send_to] = flat[self.send_from]
        return self.ctx.all_reduce(buf, self.axes)

    def update(self, flat: torch.Tensor, mom: dict, adam: dict
               ) -> torch.Tensor:
        """One step over this rank's blocks; the update of its shard's
        values (JAX order)."""
        ext = torch.cat([flat, self.meet(flat), flat.new_zeros(1)])
        out = adam8bit.update(ext[self.src], mom, 0, **adam)
        back = torch.empty_like(ext)
        back[self.src] = out  # the slots of peers' values and of 0 drop
        return back[:flat.numel()]


def _jax_index(placement, name: str, p, leaf: JaxLeaf) -> torch.Tensor:
    """The index in JAX's flat (stacked) leaf of each value of this rank's
    shard of parameter ``name``, in JAX order."""
    idx = placement.shard_index(name, p)
    shape = placement._full_shape(name, p)
    if leaf.transposed:  # (out, in) here, (in, out) in JAX
        idx, shape = idx[::-1], shape[::-1]
    strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
    flat = torch.zeros((), dtype=torch.int64)
    for i, st in zip(idx, strides):
        flat = flat[..., None] + i * st
    return flat.reshape(-1) + (leaf.layer or 0) * int(np.prod(shape))


def _gather_rows(ctx, t: torch.Tensor, axes) -> torch.Tensor:
    """Every rank's rows of ``t`` over the mesh axes, concatenated (each
    rank may hold another number of them), on ``t``'s device: over gloo
    through the host, over NCCL through the card (an offloaded state's
    rows live on the host)."""
    import torch.distributed as dist

    dev = t.device
    if axes and dist.get_backend(ctx.group(axes[0])) == "gloo":
        t = t.cpu()
    elif axes and dev.type == "cpu":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    for a in axes:
        n, group = ctx.size(a), ctx.group(a)
        count = torch.tensor([t.shape[0]], dtype=torch.int64,
                             device=t.device)
        counts = [torch.empty_like(count) for _ in range(n)]
        dist.all_gather(counts, count, group=group)
        counts = [int(c) for c in counts]
        pad = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
        parts = [torch.empty_like(pad) for _ in range(n)]
        dist.all_gather(parts, pad, group=group)
        t = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return t.to(dev)


class _Int8Shards:
    """The int8 state of a placed model's leaves (the ``moments`` hook of
    its ``Placement``): one :class:`_LeafPlan` for each leaf cut over a
    mesh axis, and the state's gather to one device's layout and back
    (checkpoints)."""

    def __init__(self, opt: "Optimizer"):
        pl, B = opt.placement, adam8bit.BLOCK
        self.ctx, self.plans = pl.ctx, {}
        for key, names in opt.groups.items():
            ps = [opt.params[n] for n in names]
            axes = pl.shard_axes(names[0], ps[0])
            if not axes:
                continue
            leaf = opt.leaves[names[0]]
            layers = 1 if leaf.layer is None else \
                _stack_len(opt.cfg, _path_str(leaf))
            numel = layers * int(np.prod(pl._full_shape(names[0], ps[0])))
            g = torch.cat([_jax_index(pl, n, p, opt.leaves[n])
                           for n, p in zip(names, ps)])
            assert bool((g[1:] > g[:-1]).all()), key
            blk = g // B
            blocks, counts = torch.unique_consecutive(blk, return_counts=True)
            whole = counts == torch.clamp(numel - blocks * B, max=B)
            cut = _gather_rows(self.ctx, blocks[~whole][:, None],
                               axes)[:, 0].unique()
            row = torch.repeat_interleave(torch.arange(blocks.numel()),
                                          counts)
            mine = ~whole[row]
            send_from = torch.nonzero(mine)[:, 0]
            send_to = torch.searchsorted(cut, blk[mine]) * B + g[mine] % B
            src = None
            if not bool(whole.all()):
                n = g.numel()
                src = torch.full((blocks.numel(), B), n + cut.numel() * B)
                at = torch.searchsorted(cut, blocks[~whole])
                src[~whole] = n + at[:, None] * B + torch.arange(B)
                src.view(-1)[row * B + g % B] = torch.arange(n)
                src = src.reshape(-1)
            dev = local(ps[0]).device  # the indices live beside the update
            self.plans[key] = _LeafPlan(
                self.ctx, axes, numel, blocks.to(dev),
                None if src is None else src.to(dev), cut.numel(),
                send_from.to(dev), send_to.to(dev))

    def _rows(self, mom: dict, plan: _LeafPlan, tag: str):
        codes = mom[f"{tag}_code"]
        pad = plan.blocks.numel() * adam8bit.BLOCK - codes.numel()
        return torch.cat([codes, codes.new_zeros(pad)]).view(
            -1, adam8bit.BLOCK), mom[f"{tag}_scale"]

    @torch.no_grad()
    def gather(self, moments: dict) -> dict:
        """The state of one device: every leaf's codes and scales whole,
        in JAX's flat order (a collective over the shard axes)."""
        out, B = dict(moments), adam8bit.BLOCK
        for key, plan in self.plans.items():
            mom, whole = moments[key], {}
            nb = -(-plan.numel // B)
            for tag in ("m", "v"):
                codes, scales = self._rows(mom, plan, tag)
                dev = codes.device
                ids = _gather_rows(self.ctx, plan.blocks.to(dev), plan.axes)
                codes = _gather_rows(self.ctx, codes, plan.axes)
                scales = _gather_rows(self.ctx, scales, plan.axes)
                full = codes.new_zeros(nb, B)
                full[ids] = codes
                s = scales.new_zeros(nb)
                s[ids] = scales
                whole[f"{tag}_code"] = full.reshape(-1)[:plan.numel]
                whole[f"{tag}_scale"] = s
            out[key] = whole
        return out

    @torch.no_grad()
    def shard(self, moments: dict) -> dict:
        """This rank's state out of one device's (:meth:`gather`'s
        inverse)."""
        out, B = dict(moments), adam8bit.BLOCK
        for key, plan in self.plans.items():
            mom, mine = moments[key], {}
            nb = -(-plan.numel // B)
            for tag in ("m", "v"):
                codes = mom[f"{tag}_code"]
                codes = torch.cat([codes, codes.new_zeros(
                    nb * B - codes.numel())]).view(nb, B)
                rows = codes[plan.blocks.to(codes.device)].reshape(-1)
                mine[f"{tag}_code"] = rows if plan.src is not None else \
                    rows[:self._shard_size(plan)]
                mine[f"{tag}_scale"] = mom[f"{tag}_scale"][
                    plan.blocks.to(codes.device)].clone()
            out[key] = mine
        return out

    @staticmethod
    def _shard_size(plan: _LeafPlan) -> int:
        """Values of a shard of whole blocks (the last may be the leaf's
        short tail)."""
        B = adam8bit.BLOCK
        if not plan.blocks.numel():
            return 0
        last = int(plan.blocks[-1])
        return (plan.blocks.numel() - 1) * B + min(B, plan.numel - last * B)


def build_optimizer(tc: TrainConfig, model: nn.Module,
                    cfg: VLMConfig) -> Optimizer:
    return Optimizer(tc, model, cfg)


def _sums_of_squares(grads: Dict[str, torch.Tensor],
                     params: Dict[str, nn.Parameter]) -> Dict[str, torch.Tensor]:
    """Parameter name -> the fp32 sum of squares of its gradient."""
    return {n: grads[n].float().square().sum() for n in params}
