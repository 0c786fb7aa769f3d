"""Placement of the model on a mesh (port of ``v2pe_tpu/parallel/mesh.py``).

The JAX package lays every parameter out by a GSPMD ``PartitionSpec``
(``_PARAM_RULES``) and lets the compiler insert the collectives. The port
keeps what those layouts mean, over ``torch.distributed``:

* ``fsdp`` shards parameters, gradients and optimizer moments, as ZeRO-3
  does: FSDP2's ``fully_shard`` over the mesh's ``fsdp`` axis, once per
  decoder layer, once per ViT layer and once for the rest of the model.
  Gradients are reduce-scattered as sums (the CE's denominator is already
  global, ``train/train_step.py``).
* ``tensor`` is a Megatron split over heads and FFN width. A unit (an
  attention block, an MLP, the projector) splits its first product's
  outputs (column-parallel) and its last product's inputs (row-parallel),
  and one all-reduce over ``tensor`` follows the row-parallel product; the
  row-parallel bias is added after it. The splits fall on head boundaries:
  InternLM2's fused ``wqkv`` is interleaved by KV group, so a contiguous
  run of its rows is a run of whole KV groups (``Hkv % tensor == 0``);
  InternViT's ``qkv`` is ``[q | k | v]``, each split by head on its own.
* ``data`` and ``seq`` replicate the parameters; their gradients are
  summed over those axes after the backward (:meth:`Placement.reduce_grads`).

``_fit_spec``'s rule stays: a unit whose width the ``tensor`` axis does not
divide stays whole on every rank. The vocab (tok_embeddings and the output
head) is never split over ``tensor``: InternVL2's 92,553 entries do not
divide, and no vocab-parallel CE is ported.

The batch rule is ``batch_sharding``'s: rows over (data, fsdp), tokens
over ``seq`` (``parallel/bootstrap.py:make_global_batch``).
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.parallel import context as pctx


class TensorRule(NamedTuple):
    dim: int      # the dimension split over ``tensor``
    blocks: int   # it is ``blocks`` equal blocks, each split on its own
    unit: str     # which width must divide (see ``_unit_width``)


# port parameter name -> how its tensor-parallel slice is cut; every other
# parameter is whole on each tensor rank
_TENSOR_RULES = [
    (r"llm\.layers\.\d+\.wqkv\.(weight|bias)", TensorRule(0, 1, "llm_attn")),
    (r"llm\.layers\.\d+\.wo\.weight", TensorRule(1, 1, "llm_attn")),
    (r"llm\.layers\.\d+\.w[13]\.weight", TensorRule(0, 1, "llm_mlp")),
    (r"llm\.layers\.\d+\.w2\.weight", TensorRule(1, 1, "llm_mlp")),
    (r"vision\.layers\.\d+\.qkv\.(weight|bias)",
     TensorRule(0, 3, "vit_attn")),
    (r"vision\.layers\.\d+\.[qk]_norm", TensorRule(0, 1, "vit_attn")),
    (r"vision\.layers\.\d+\.proj\.weight", TensorRule(1, 1, "vit_attn")),
    (r"vision\.layers\.\d+\.fc1\.(weight|bias)", TensorRule(0, 1, "vit_mlp")),
    (r"vision\.layers\.\d+\.fc2\.weight", TensorRule(1, 1, "vit_mlp")),
    (r"mlp1\.fc1\.(weight|bias)", TensorRule(0, 1, "projector")),
    (r"mlp1\.fc2\.weight", TensorRule(1, 1, "projector")),
]


def _unit_width(cfg: VLMConfig, unit: str) -> int:
    """The count the ``tensor`` axis must divide for a unit to split."""
    return {"llm_attn": cfg.llm.num_key_value_heads,
            "llm_mlp": cfg.llm.intermediate_size,
            "vit_attn": cfg.vision.num_attention_heads,
            "vit_mlp": cfg.vision.intermediate_size,
            "projector": cfg.llm.hidden_size}[unit]


def tensor_rules(model: nn.Module, cfg: VLMConfig,
                 tensor: int) -> Dict[str, TensorRule]:
    """Parameter name -> its rule, for the parameters that split over a
    ``tensor`` axis of that size (``_fit_spec``: none of a unit whose width
    the axis does not divide)."""
    if tensor == 1:
        return {}
    out = {}
    for name, _ in model.named_parameters():
        for pattern, rule in _TENSOR_RULES:
            if re.fullmatch(pattern, name) and \
                    _unit_width(cfg, rule.unit) % tensor == 0:
                out[name] = rule
    return out


def tensor_slice(x: torch.Tensor, rule: TensorRule, n: int,
                 i: int) -> torch.Tensor:
    """Rank i's slice of a whole parameter under ``rule`` over n ranks."""
    blocks = x.unflatten(rule.dim, (rule.blocks, -1))
    return blocks.chunk(n, rule.dim + 1)[i].flatten(rule.dim, rule.dim + 1)


def tensor_join(parts, rule: TensorRule) -> torch.Tensor:
    """The whole parameter from every rank's slice (rank order)."""
    return torch.cat([p.unflatten(rule.dim, (rule.blocks, -1))
                      for p in parts], rule.dim + 1).flatten(rule.dim,
                                                             rule.dim + 1)


# --------------------------------------------------------------------------
# Megatron's two operators over the tensor group
# --------------------------------------------------------------------------


def _tensor_group():
    ctx = pctx.current()
    if ctx is None or ctx.size("tensor") == 1:
        raise RuntimeError("a tensor-split layer runs under the "
                           "ShardingContext of its placement")
    return ctx.group("tensor")


class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    tensor ranks (each saw a part of the products)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTensor(torch.autograd.Function):
    """All-reduce forward (the row-parallel product's partial sums);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """All-reduce forward and backward: every rank's output depends on
    every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def column_input(x: torch.Tensor, split: bool) -> torch.Tensor:
    """The input of a unit's column-parallel product."""
    return _CopyToTensor.apply(x, _tensor_group()) if split else x


def row_output(y: torch.Tensor, split: bool,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A row-parallel product's output summed over the tensor ranks, then
    its bias (once)."""
    if split:
        y = _ReduceFromTensor.apply(y, _tensor_group())
    return y if bias is None else y + bias


def row_linear(x: torch.Tensor, linear: nn.Linear,
               split: bool) -> torch.Tensor:
    """A unit's last ``nn.Linear``: whole, or row-parallel (the product of
    this rank's slice, summed over the tensor ranks, then the bias)."""
    if not split:
        return linear(x)
    return row_output(F.linear(x, linear.weight), True, linear.bias)


def tensor_sum(x: torch.Tensor) -> torch.Tensor:
    """A partial sum over the tensor ranks made whole (differentiable)."""
    return _AllReduceSum.apply(x, _tensor_group())


def is_split(linear, full_in: int) -> bool:
    """Whether a row-parallel ``nn.Linear`` holds a slice of its inputs."""
    return isinstance(linear, nn.Linear) and linear.in_features != full_in


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------

REDUCE_BUCKET = 1 << 26  # gradient elements a data / seq all-reduce


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage); a tensor as it
    is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _fsdp_chunk(full: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rank i's dim-0 chunk of FSDP2's sharding (``torch.chunk``; ranks
    past the last chunk hold none)."""
    chunks = torch.chunk(full, n, dim=0)
    return chunks[i] if i < len(chunks) else full[:0]


class Placement:
    """How a model sits on a mesh: its context and its tensor rules.
    ``shard_model`` attaches one to the model as ``model.placement``."""

    def __init__(self, ctx: pctx.ShardingContext,
                 rules: Dict[str, TensorRule]):
        self.ctx = ctx
        self.rules = rules

    # the parameters' whole values ------------------------------------

    def _full(self, name: str, shard: torch.Tensor, like) -> torch.Tensor:
        """The whole value of a tensor laid out like parameter ``like``
        (``shard``: this rank's part of it)."""
        from torch.distributed.tensor import DTensor

        if isinstance(like, DTensor):
            shard = DTensor.from_local(
                shard, like.device_mesh, like.placements, run_check=False,
                shape=like.shape, stride=like.stride()).full_tensor()
        rule = self.rules.get(name)
        if rule is not None:
            n = self.ctx.size("tensor")
            parts = [torch.empty_like(shard) for _ in range(n)]
            dist.all_gather(parts, shard.contiguous(),
                            group=self.ctx.group("tensor"))
            shard = tensor_join(parts, rule)
        return shard

    def _shard(self, name: str, full: torch.Tensor, like) -> torch.Tensor:
        """This rank's shard of a whole value laid out like ``like``."""
        from torch.distributed.tensor import DTensor

        rule = self.rules.get(name)
        if rule is not None:
            full = tensor_slice(full, rule, self.ctx.size("tensor"),
                                self.ctx.coord("tensor"))
        if isinstance(like, DTensor):
            full = _fsdp_chunk(full, self.ctx.size("fsdp"),
                               self.ctx.coord("fsdp"))
        return full

    @torch.no_grad()
    def full_state_dict(self, model: nn.Module) -> dict:
        """Every parameter whole, in the layout of the unsharded model (a
        collective: every rank calls it)."""
        return {n: self._full(n, local(p), p).detach()
                for n, p in model.named_parameters()}

    @torch.no_grad()
    def load_full_state_dict(self, model: nn.Module, sd: dict) -> None:
        """Copy a whole state dict into the model's shards."""
        got, want = set(sd), {n for n, _ in model.named_parameters()}
        if got != want:
            raise KeyError(f"state dict keys differ: missing "
                           f"{sorted(want - got)[:5]}, unexpected "
                           f"{sorted(got - want)[:5]}")
        for n, p in model.named_parameters():
            dst = local(p)
            src = self._shard(n, sd[n], p)
            if src.shape != dst.shape:
                raise ValueError(f"{n}: shard {tuple(src.shape)} against "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    def _per_param(self, model, state, fn):
        params = dict(model.named_parameters())

        def walk(obj):
            if isinstance(obj, dict):
                return {k: (fn(k, v, params[k]) if k in params
                            and torch.is_tensor(v) else walk(v))
                        for k, v in obj.items()}
            return obj

        return walk(state)

    @torch.no_grad()
    def gather_state(self, model: nn.Module, state: dict) -> dict:
        """An optimizer state with every per-parameter tensor (keyed by
        the parameter's name, shaped like its shard) whole."""
        return self._per_param(
            model, state, lambda n, v, p: self._full(n, v, p)
            if v.shape == local(p).shape else v)

    def _full_shape(self, name: str, p) -> tuple:
        shape = list(p.shape)
        rule = self.rules.get(name)
        if rule is not None:
            shape[rule.dim] *= self.ctx.size("tensor")
        return tuple(shape)

    @torch.no_grad()
    def shard_state(self, model: nn.Module, full: dict) -> dict:
        """The inverse of :meth:`gather_state`."""
        return self._per_param(
            model, full, lambda n, v, p: self._shard(n, v, p).clone()
            if tuple(v.shape) == self._full_shape(n, p) else v)

    # gradients -----------------------------------------------------------

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the (local) gradients over ``data`` and ``seq`` in place:
        those ranks hold the same parameters and saw other tokens. FSDP2
        has summed them over ``fsdp`` already."""
        axes = [a for a in ("data", "seq") if self.ctx.size(a) > 1]
        if not axes:
            return
        bucket, size = [], 0
        for g in list(grads.values()) + [None]:
            if g is not None:
                bucket.append(g)
                size += g.numel()
            if bucket and (g is None or size >= REDUCE_BUCKET):
                # one fp32 all-reduce a bucket of gradients
                flat = torch.cat([b.reshape(-1).float() for b in bucket])
                self.ctx.all_reduce(flat, axes)
                at = 0
                for b in bucket:
                    b.copy_(flat[at:at + b.numel()].view_as(b))
                    at += b.numel()
                bucket, size = [], 0

    def sum_of_shards(self, per_param: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
        """The global sum of per-parameter partial sums (of squares, say)
        taken over each rank's shards: summed over ``fsdp`` and
        ``tensor``, a parameter whole on every tensor rank counted once."""
        keep_whole = self.ctx.coord("tensor") == 0
        terms = [s for n, s in per_param.items()
                 if n in self.rules or keep_whole]
        dev = next(iter(per_param.values())).device if per_param else None
        total = torch.stack(terms).sum() if terms else \
            torch.zeros((), device=dev)
        return self.ctx.all_reduce(total.float().clone(), ("fsdp", "tensor"))


def placement_of(model: nn.Module) -> Optional[Placement]:
    return getattr(model, "placement", None)


def shard_model(model: nn.Module, cfg: VLMConfig,
                ctx: Optional[pctx.ShardingContext]) -> nn.Module:
    """Place a whole model on ``ctx``'s mesh, in place: each tensor rank
    keeps its slice of the split parameters (``nn.Linear``'s
    ``in_features`` / ``out_features`` follow), then FSDP2 shards every
    decoder layer, every ViT layer and the rest over ``fsdp``. Without a
    mesh the model is left as it is. Every rank must pass the same whole
    weights."""
    if ctx is None or ctx.mesh is None:
        return model
    if placement_of(model) is not None:
        raise ValueError("the model is placed already")
    if getattr(model, "compress", None) is not None:
        raise NotImplementedError(
            "compress-seq under a mesh is not ported (ROADMAP Queue 1 "
            "item 6)")
    if not isinstance(model.llm.layers[0].wo, nn.Linear):
        raise NotImplementedError("a quantized decoder serves; it is not "
                                  "placed on a training mesh")
    from torch.distributed.fsdp import FSDPModule, fully_shard

    rules = tensor_rules(model, cfg, ctx.size("tensor"))
    mods = dict(model.named_modules())
    with torch.no_grad():
        for name, rule in rules.items():
            owner_name, attr = name.rsplit(".", 1)
            owner = mods[owner_name]
            p = getattr(owner, attr)
            setattr(owner, attr, nn.Parameter(
                tensor_slice(p.detach(), rule, ctx.size("tensor"),
                             ctx.coord("tensor")).clone(),
                requires_grad=p.requires_grad))
            if isinstance(owner, nn.Linear) and attr == "weight":
                owner.out_features, owner.in_features = owner.weight.shape
    fsdp_mesh = ctx.mesh["fsdp"]
    for layer in list(model.llm.layers) + list(model.vision.layers):
        fully_shard(layer, mesh=fsdp_mesh)
    fully_shard(model, mesh=fsdp_mesh)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            # the loss is already a global mean: the reduce-scatter sums
            if hasattr(m, "set_gradient_divide_factor"):
                m.set_gradient_divide_factor(1.0)
            else:  # the name before torch 2.8
                m.set_reduce_scatter_divide_factor(1.0)
            if hasattr(m, "set_force_sum_reduction_for_comms"):
                m.set_force_sum_reduction_for_comms(True)
    model.placement = Placement(ctx, rules)
    return model
