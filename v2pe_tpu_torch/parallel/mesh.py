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

A quantized decoder (int8 / int4 serving weights) splits over ``tensor`` by
the same units, its codes and scales cut as the bf16 weights are
(:func:`quantized_tensor_units`; int4 row splits on whole scale groups), so
each rank's products run the quantized kernels on its slice. It stays whole
over ``fsdp`` and ``data``, where JAX shards it: a difference of placement,
not of numerics.

The batch rule is ``batch_sharding``'s: rows over (data, fsdp), tokens
over ``seq`` (``parallel/bootstrap.py:make_global_batch``).
"""

from __future__ import annotations

import functools
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
    # compress-seq: the interaction attention as the layer's own; the
    # cross-attention fuse's wq (query heads) and wkv (k, v a KV head)
    (r"compress\.interaction\.\d+\.wqkv\.(weight|bias)",
     TensorRule(0, 1, "llm_attn")),
    (r"compress\.interaction\.\d+\.wo\.weight", TensorRule(1, 1, "llm_attn")),
    (r"compress\.fuse\.\d+\.w(q|kv)\.weight", TensorRule(0, 1, "llm_attn")),
    (r"compress\.fuse\.\d+\.wo\.weight", TensorRule(1, 1, "llm_attn")),
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


def in_features(w) -> int:
    """The inputs of a product's weight: an ``nn.Linear``, or a quantized
    weight (a layer of a stack, ``StackedQuantizedRef``, or a 2-D one; an
    int4 payload holds two rows a byte)."""
    if isinstance(w, nn.Linear):
        return w.in_features
    from v2pe_tpu_torch.ops.quantized_matmul import (Int4Weight,
                                                     StackedQuantizedRef)

    qw = w.qw if isinstance(w, StackedQuantizedRef) else w
    rows = qw.payload.shape[-2]
    return 2 * rows if isinstance(qw, Int4Weight) else rows


def is_split(w, full_in: int) -> bool:
    """Whether a row-parallel product's weight (an ``nn.Linear`` or a
    quantized weight) holds a slice of its inputs."""
    return in_features(w) != full_in


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
    ``shard_model`` attaches one to the model as ``model.placement``; a
    LoRA adapter set placed beside it gets one too (``fsdp=False``: the
    adapters stay whole over ``fsdp``, and ``partial`` names the adapter
    tensors whose gradients each tensor rank holds a part of).
    ``moments``: the int8 Adam state's own gather and shard (set by the
    optimizer, ``train/optimizer.py``), since its blocks do not follow the
    parameters' shards."""

    def __init__(self, ctx: pctx.ShardingContext,
                 rules: Dict[str, TensorRule], fsdp: bool = True,
                 partial=()):
        self.ctx = ctx
        self.rules = rules
        self.fsdp = fsdp
        self.partial = sorted(partial)  # one order on every rank
        self.moments = None

    def shard_axes(self, name: str, p) -> tuple:
        """The mesh axes above 1 over which parameter ``name`` is cut."""
        from torch.distributed.tensor import DTensor

        axes = [a for a, cut in (("fsdp", isinstance(p, DTensor)),
                                 ("tensor", name in self.rules))
                if cut and self.ctx.size(a) > 1]
        return tuple(axes)

    def shard_index(self, name: str, p) -> list:
        """For each dimension of parameter ``name``, the indices into the
        whole parameter of this rank's shard along it (int64, ascending;
        the shard is the whole parameter indexed by each in turn)."""
        from torch.distributed.tensor import DTensor

        rule = self.rules.get(name)
        out = []
        for d, size in enumerate(self._full_shape(name, p)):
            idx = torch.arange(size)
            if rule is not None and rule.dim == d:
                idx = tensor_slice(idx, TensorRule(0, rule.blocks, rule.unit),
                                   self.ctx.size("tensor"),
                                   self.ctx.coord("tensor"))
            if d == 0 and isinstance(p, DTensor):
                idx = _fsdp_chunk(idx, self.ctx.size("fsdp"),
                                  self.ctx.coord("fsdp"))
            out.append(idx)
        return out

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

    def _buffers(self, model: nn.Module) -> dict:
        """The buffers a placed adapter set's state dict carries (each
        adapter's ``alpha``); a placed model's are not saved."""
        return {} if self.fsdp else dict(model.named_buffers())

    @torch.no_grad()
    def full_state_dict(self, model: nn.Module) -> dict:
        """Every parameter whole, in the layout of the unsharded model (a
        collective: every rank calls it)."""
        out = {n: self._full(n, local(p), p).detach()
               for n, p in model.named_parameters()}
        return {**out, **{n: b.detach() for n, b in
                          self._buffers(model).items()}}

    @torch.no_grad()
    def load_full_state_dict(self, model: nn.Module, sd: dict) -> None:
        """Copy a whole state dict into the model's shards."""
        buffers = self._buffers(model)
        for n, b in buffers.items():
            b.copy_(sd[n])
        sd = {n: v for n, v in sd.items() if n not in buffers}
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
        the parameter's name, shaped like its shard) whole, and the int8
        moments in the layout of one device."""
        if "moments" in state and self.moments is not None:
            state = dict(state, moments=self.moments.gather(
                state["moments"]))
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
        if "moments" in full and self.moments is not None:
            full = dict(full, moments=self.moments.shard(full["moments"]))
        return self._per_param(
            model, full, lambda n, v, p: self._shard(n, v, p).clone()
            if tuple(v.shape) == self._full_shape(n, p) else v)

    # gradients -----------------------------------------------------------

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Sum the (local) gradients over ``data`` and ``seq`` in place:
        those ranks hold the same parameters and saw other tokens. FSDP2
        has summed them over ``fsdp`` already; adapters, whole over
        ``fsdp``, are summed over it here, and the ``partial`` ones over
        ``tensor`` too."""
        axes = ["data", "seq"] + ([] if self.fsdp else ["fsdp"])
        _sum_over(self.ctx, list(grads.values()), axes)
        _sum_over(self.ctx, [grads[n] for n in self.partial], ["tensor"])

    def sum_of_shards(self, per_param: Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
        """The global sum of per-parameter partial sums (of squares, say)
        taken over each rank's shards: summed over ``fsdp`` and
        ``tensor``, a parameter whole on every tensor rank counted once."""
        keep_whole = self.ctx.coord("tensor") == 0
        terms = [s for n, s in per_param.items()
                 if n in self.rules or keep_whole]
        dev = next(iter(per_param.values())).device if per_param else None
        # summed in the unplaced optimizer's order (``sum`` of the terms),
        # so that a world of 1 clips by the same norm to the bit
        total = sum(terms) if terms else torch.zeros((), device=dev)
        return self.ctx.all_reduce(total.float().clone(),
                                   ("fsdp", "tensor") if self.fsdp
                                   else ("tensor",))


def _sum_over(ctx, tensors, axes) -> None:
    """Sum ``tensors`` in place over the mesh axes (those above 1), one
    fp32 all-reduce a bucket of about ``REDUCE_BUCKET`` elements."""
    axes = [a for a in axes if ctx.size(a) > 1]
    if not axes:
        return
    bucket, size = [], 0
    for g in list(tensors) + [None]:
        if g is not None:
            bucket.append(g)
            size += g.numel()
        if bucket and (g is None or size >= REDUCE_BUCKET):
            flat = torch.cat([b.reshape(-1).float() for b in bucket])
            ctx.all_reduce(flat, axes)
            at = 0
            for b in bucket:
                b.copy_(flat[at:at + b.numel()].view_as(b))
                at += b.numel()
            bucket, size = [], 0


def placement_of(model: nn.Module) -> Optional[Placement]:
    return getattr(model, "placement", None)


def serving_mode(fn):
    """Run a serving entry point (a function or a generator) without
    autograd: under ``torch.inference_mode``, or ``torch.no_grad`` for a
    model that FSDP2 holds (``shard_model``), whose hooks gather a layer's
    weights into tensors that inference mode refuses. The call's first
    argument names the model: the model, its decoder, or an object serving
    a ``ChatModel`` as ``.m``."""
    held, alone = torch.no_grad()(fn), torch.inference_mode()(fn)

    @functools.wraps(fn)
    def wrapped(first, *args, **kwargs):
        run = held if _fsdp_held(first) else alone
        return run(first, *args, **kwargs)
    return wrapped


def _fsdp_held(first) -> bool:
    from torch.distributed.fsdp import FSDPModule

    model = first.m.model if hasattr(first, "m") else first
    llm = getattr(model, "llm", model)
    return isinstance(llm.layers[0], FSDPModule)


def _serving_root(model: nn.Module) -> None:
    """The end of a serving placement under FSDP2: the model made FSDP2's
    root (FSDP2 takes the first module whose forward runs, and serving
    calls the layers first, so a layer would be taken and keep its weights
    whole after its call) and the parameters of its root unit (the
    embedding, the final norm, the head, the ViT's embeddings, the
    projector) gathered whole and kept so, since serving calls them outside
    the model's forward. The decoder and ViT layers gather theirs at each
    call of the module. One all-gather over ``fsdp``."""
    model._get_fsdp_state()._lazy_init()
    model.unshard()


# --------------------------------------------------------------------------
# a quantized decoder over ``tensor``
# --------------------------------------------------------------------------

# stack name -> (unit, split side): "col" splits the output columns (the
# bf16 rule's dim 0 of an nn.Linear weight), "row" the contracted rows
_QUANT_RULES = {"wqkv": ("llm_attn", "col"), "wo": ("llm_attn", "row"),
                "w1": ("llm_mlp", "col"), "w3": ("llm_mlp", "col"),
                "w2": ("llm_mlp", "row")}


def _quant_slice(w, side: str, n: int, i: int):
    """Rank i's slice of a layer-stacked quantized weight under n ranks:
    its output columns (codes and scales, re-padded to the lane width) or
    its contracted rows (int8: the per-column scale whole, as it spans
    every row; int4: whole scale groups, the rows unpacked and packed
    again in the slice's two halves)."""
    from v2pe_tpu_torch.ops.quantized_matmul import (LANE, Int4Weight,
                                                     _pad_last,
                                                     unpack_nibbles)

    int4 = isinstance(w, Int4Weight)
    extra = (w.group_size,) if int4 else ()
    payload, scale = w.payload, w.scale
    if side == "col":
        n_out = w.n_out // n
        cols = slice(i * n_out, (i + 1) * n_out)
        pad = (-n_out) % LANE
        return type(w)(_pad_last(payload[..., cols], pad, 0).clone(),
                       _pad_last(scale[..., cols], pad, 1.0).clone(), n_out,
                       *extra)
    if not int4:
        rows = payload.shape[-2] // n
        return type(w)(payload[..., i * rows:(i + 1) * rows, :].clone(),
                       scale.clone(), w.n_out)
    lo, hi = unpack_nibbles(payload)
    codes = torch.cat([lo, hi], dim=-2)             # (L, D, Npad)
    rows = codes.shape[-2] // n
    mine = codes[..., i * rows:(i + 1) * rows, :]
    half = rows // 2
    packed = ((mine[..., :half, :] & 0xF) | (mine[..., half:, :] << 4))
    groups = scale.shape[-2] // n
    return type(w)(packed.to(torch.int8),
                   scale[..., i * groups:(i + 1) * groups, :].clone(),
                   w.n_out, w.group_size)


def quantized_tensor_units(llm, cfg: VLMConfig, tensor: int) -> list:
    """The units of a quantized decoder that split over a ``tensor`` axis
    of that size: ``_fit_spec``'s rule (the axis divides the unit's width)
    and, for int4, whole scale groups in each half of a rank's rows (the
    int4 product takes a weight's two halves group by group); a unit that
    fails either stays whole."""
    from v2pe_tpu_torch.ops.quantized_matmul import Int4Weight

    if tensor == 1:
        return []
    out = []
    for unit, row_name in (("llm_attn", "wo"), ("llm_mlp", "w2")):
        w = llm.stacks[row_name]
        if _unit_width(cfg, unit) % tensor:
            continue
        if isinstance(w, Int4Weight):
            rows = 2 * w.payload.shape[-2] // tensor
            if rows % (2 * w.group_size):
                continue
        out.append(unit)
    return out


@torch.no_grad()
def _shard_quantized_llm(llm, cfg: VLMConfig, ctx) -> list:
    """Slice a ``QuantizedInternLM2``'s stacks (and the qkv bias) over the
    ``tensor`` axis in place, and point its layers at the slices. The
    vocab head stays whole. Returns the split units."""
    from v2pe_tpu_torch.ops.quantized_matmul import StackedQuantizedRef

    n, i = ctx.size("tensor"), ctx.coord("tensor")
    units = quantized_tensor_units(llm, cfg, n)
    for name, (unit, side) in _QUANT_RULES.items():
        if unit in units:
            llm.stacks[name] = _quant_slice(llm.stacks[name], side, n, i)
    for li, layer in enumerate(llm.layers):
        for name in _QUANT_RULES:
            setattr(layer, name, StackedQuantizedRef(llm.stacks[name], li))
        if "llm_attn" in units and layer.wqkv_bias is not None:
            layer.wqkv_bias = nn.Parameter(
                layer.wqkv_bias.chunk(n)[i].clone(), requires_grad=False)
    return units


def _split_over_tensor(model: nn.Module, cfg: VLMConfig,
                       ctx: pctx.ShardingContext) -> Dict[str, TensorRule]:
    """Each tensor rank keeps its slice of the split parameters, in place
    (``nn.Linear``'s ``in_features`` / ``out_features`` follow); returns
    the rules."""
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
    return rules


def _fully_shard(model: nn.Module, ctx: pctx.ShardingContext) -> None:
    """FSDP2 over ``fsdp``: every decoder layer, every ViT layer, then the
    rest (the root unit: embeddings, head, projector, compress-seq's
    parameters), reduce-scattering sums."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

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


def shard_model(model: nn.Module, cfg: VLMConfig,
                ctx: Optional[pctx.ShardingContext],
                serving: bool = False) -> nn.Module:
    """Place a whole model on ``ctx``'s mesh, in place: each tensor rank
    keeps its slice of the split parameters (``nn.Linear``'s
    ``in_features`` / ``out_features`` follow), then FSDP2 shards every
    decoder layer, every ViT layer and the rest over ``fsdp``. A model with
    a quantized decoder (``QuantizedInternLM2``, serving) has its stacks
    sliced over ``tensor`` by the same head and FFN split
    (:func:`quantized_tensor_units`) and stays whole over ``fsdp`` and
    ``data``: no FSDP2. A compress-seq model's interaction and fuse
    attentions split over ``tensor`` as the layers' attention does, and
    sit in the root unit over ``fsdp`` (``models/compress_seq.py`` runs
    each decoder layer's part through the layer's call). Without a mesh the
    model is left as it is. Every rank must pass the same whole weights.
    ``serving``: the placement of a model that only serves
    (``_serving_root``): its root unit stays gathered, so the serving entry
    points take it as it is; a model to be trained is placed without it
    (its optimizer takes the sharded parameters)."""
    if ctx is None or ctx.mesh is None:
        return model
    if placement_of(model) is not None:
        raise ValueError("the model is placed already")
    quantized = not isinstance(model.llm.layers[0].wo, nn.Linear)
    if quantized:  # serving: sliced over tensor, whole over fsdp and data
        _shard_quantized_llm(model.llm, cfg, ctx)
    rules = _split_over_tensor(model, cfg, ctx)
    if not quantized:
        _fully_shard(model, ctx)
        if serving:
            _serving_root(model)
    model.placement = Placement(ctx, rules)
    return model


def place_lora(model: nn.Module, lora, cfg: VLMConfig,
               ctx: pctx.ShardingContext) -> nn.Module:
    """LoRA on a mesh: the training forward's model, a frozen view of the
    whole base ``model`` (``models/lora.py:lora_view``; the base is left
    as it was) placed as :func:`shard_model` places a model, each target's
    weight the merge of its slice and the adapter's; and the adapters
    placed beside it (``lora.placement``). Over ``tensor`` a
    column-parallel target's ``B`` splits its rows with the weight (``A``
    whole; its gradient a part on each rank, summed over ``tensor``), a
    row-parallel target's ``A`` its columns (``B`` likewise whole). Over
    ``fsdp`` and ``data`` the adapters stay whole and their gradients are
    summed. Returns the view."""
    from v2pe_tpu_torch.models.lora import frozen, merge_targets

    view = frozen(model)
    rules = _split_over_tensor(view, cfg, ctx)
    n, i = ctx.size("tensor"), ctx.coord("tensor")
    ad_rules, partial = {}, []
    with torch.no_grad():
        for name, ad in lora.targets().items():
            rule = rules.get(name + ".weight")
            if rule is None:
                continue
            cut, whole = ("B", "A") if rule.dim == 0 else ("A", "B")
            r = TensorRule(rule.dim, rule.blocks, rule.unit)
            t = getattr(ad, cut)
            setattr(ad, cut, nn.Parameter(tensor_slice(t.detach(), r, n, i)
                                          .clone()))
            ad_rules[f"{name}.{cut}"] = r
            partial.append(f"{name}.{whole}")
    merge_targets(view, lora)
    _fully_shard(view, ctx)
    view.placement = Placement(ctx, rules)
    lora.placement = Placement(ctx, ad_rules, fsdp=False, partial=partial)
    return view
