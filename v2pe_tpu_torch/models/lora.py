"""LoRA adapters (port of ``v2pe_tpu/models/lora.py``).

The reference's peft wrappers (``wrap_backbone_lora`` / ``wrap_llm_lora``;
targets: the ViT's ``qkv`` / ``proj``, the LLM's ``wqkv`` / ``wo`` / ``w1`` /
``w2`` / ``w3``) become an explicit :class:`LoRA` module tree: one
:class:`Adapter` per target ``nn.Linear``, under the target's own module
name (``llm.layers.3.wqkv.A``). An adapter holds ``A`` (r, in) and ``B``
(out, r) in the Linear layout (the JAX tree's ``a`` (in, r) and ``b``
(r, out) transposed, one layer of its stacked (L, ...) leaves), in fp32,
and ``alpha`` as a buffer: the merged weight is
``W' = (W.float() + (B @ A) * (alpha / r)).to(W.dtype)``.

Two ways to apply them, as in the JAX package:

- :func:`merge_lora` for inference and export: a new model whose target
  weights are new merged tensors; every other module is the caller's own,
  and the caller's model is left as it was;
- :func:`lora_view` for training: a view of the base model whose
  parameters alias the base's storage with ``requires_grad=False``, and
  whose target Linears compute their weight as the merge of the base
  weight and the adapter (a ``torch.nn.utils.parametrize``
  parametrization, so the merge is recomputed inside remat's checkpointed
  blocks); gradients flow into ``A`` and ``B`` only.
"""

from __future__ import annotations

import copy
import re
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from v2pe_tpu_torch.models.params import JaxLeaf

# peft target parity (modeling_internvl_chat.py:144-146, 155-158), on the
# port's module names
BACKBONE_TARGETS = [r"vision\.layers\.\d+\.qkv", r"vision\.layers\.\d+\.proj"]
LLM_TARGETS = [rf"llm\.layers\.\d+\.{n}" for n in ("wqkv", "wo", "w1", "w2",
                                                  "w3")]


class Adapter(nn.Module):
    """The low-rank pair of one target Linear (out, in): ``A`` (r, in),
    ``B`` (out, r), and the fixed ``alpha`` (a buffer: the JAX step stops
    its gradient)."""

    def __init__(self, r: int, fan_in: int, fan_out: int, alpha: float,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.A = nn.Parameter(torch.zeros(r, fan_in, device=device,
                                          dtype=dtype))
        self.B = nn.Parameter(torch.zeros(fan_out, r, device=device,
                                          dtype=dtype))
        self.register_buffer("alpha", torch.tensor(
            float(alpha), dtype=torch.float32, device=device))

    @property
    def r(self) -> int:
        return self.A.shape[0]

    def merged(self, w: torch.Tensor) -> torch.Tensor:
        """``w`` (out, in) plus the adapter's delta, in fp32, cast back to
        ``w``'s dtype; the product is a plain matmul, as the JAX merge's
        einsum runs outside any kernel."""
        delta = torch.matmul(self.B.float(), self.A.float()) \
            * (self.alpha / self.r)
        return (w.float() + delta).to(w.dtype)


class LoRA(nn.Module):
    """Adapters under the names of their target modules (plain container
    modules in between)."""

    def add(self, name: str, adapter: Adapter) -> None:
        node = self
        for part in name.split(".")[:-1]:
            if part not in node._modules:
                node.add_module(part, nn.Module())
            node = node._modules[part]
        node.add_module(name.split(".")[-1], adapter)

    def targets(self) -> Dict[str, Adapter]:
        """Target module name -> its adapter."""
        return {n: m for n, m in self.named_modules()
                if isinstance(m, Adapter)}


def _match(name: str, targets: List[str]) -> bool:
    return any(re.fullmatch(t, name) for t in targets)


@torch.no_grad()
def init_lora(generator: torch.Generator, model: nn.Module,
              targets: List[str], r: int = 16, alpha: Optional[float] = None,
              dtype=torch.float32) -> LoRA:
    """Adapters for the Linears of ``model`` whose names match a pattern
    of ``targets``: ``A`` ~ N(0, 0.01^2) drawn from ``generator`` (on the
    model's device), ``B`` = 0, alpha 2r by default (the reference's
    ``lora_alpha = 2 * r``)."""
    alpha = alpha if alpha is not None else 2.0 * r
    lora = LoRA()
    for name, m in model.named_modules():
        if isinstance(m, nn.Linear) and _match(name, targets):
            dev = m.weight.device
            ad = Adapter(r, m.in_features, m.out_features, alpha, dev, dtype)
            ad.A.copy_(torch.randn(r, m.in_features, generator=generator,
                                   device=dev) * 0.01)
            lora.add(name, ad)
    return lora


def combine_lora(*loras: LoRA) -> LoRA:
    """The union of adapter sets built over the same model (the backbone's
    and the LLM's, at their own ranks); a target in two of them raises."""
    out = LoRA()
    for lora in loras:
        for name, ad in lora.targets().items():
            if name in out.targets():
                raise ValueError(f"overlapping LoRA target sets at {name}")
            out.add(name, ad)
    return out


def build_lora(generator: torch.Generator, model: nn.Module,
               backbone_r: int = 0, llm_r: int = 0,
               dtype=torch.float32) -> Optional[LoRA]:
    """The reference's use_backbone_lora / use_llm_lora entry: a rank per
    tower, the peft-parity targets, alpha 2r. None when both ranks are 0.
    The backbone's adapters are drawn first, then the LLM's."""
    if not backbone_r and not llm_r:
        return None
    sets = []
    if backbone_r:
        sets.append(init_lora(generator, model, BACKBONE_TARGETS,
                              r=backbone_r, dtype=dtype))
    if llm_r:
        sets.append(init_lora(generator, model, LLM_TARGETS, r=llm_r,
                              dtype=dtype))
    return sets[0] if len(sets) == 1 else combine_lora(*sets)


def lora_trainable_mask(model: nn.Module, lora: LoRA) -> Dict[str, bool]:
    """Parameter name of ``model`` -> whether an adapter trains it (the
    target Linears' weights; their biases and everything else stay
    frozen)."""
    targets = lora.targets()
    return {n: n.endswith(".weight") and n[:-len(".weight")] in targets
            for n, _ in model.named_parameters()}


# ---------------------------------------------------------------- applying


def _shallow(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with its own parameter, buffer and child dicts
    and its own hook registries (so that replacing an entry, or a hook a
    placement registers on the copy, leaves ``module`` as it was), sharing
    every tensor and child."""
    new = copy.copy(module)
    for k, v in module.__dict__.items():
        if isinstance(v, (dict, set)):
            new.__dict__[k] = copy.copy(v)
    return new


def _copy_paths(model: nn.Module, names) -> tuple:
    """(root, {name: module}) where the modules named and their ancestors
    are shallow copies and every other module is ``model``'s own."""
    root, copied, out = _shallow(model), set(), {}
    copied.add(id(root))
    for name in names:
        node = root
        for part in name.split("."):
            child = node._modules[part]
            if id(child) not in copied:
                child = _shallow(child)
                copied.add(id(child))
                node._modules[part] = child
            node = child
        out[name] = node
    return root, out


@torch.no_grad()
def merge_lora(model: nn.Module, lora: LoRA) -> nn.Module:
    """The model with ``W' = W + (alpha / r) B A`` at every target: new
    tensors for the target weights (fp32 sums cast to the weight's
    dtype), every other module shared with ``model``, which stays as it
    was."""
    targets = lora.targets()
    root, mods = _copy_paths(model, targets)
    for name, m in mods.items():
        w = m._parameters["weight"]
        m._parameters["weight"] = nn.Parameter(
            targets[name].merged(w), requires_grad=w.requires_grad)
    return root


class _Merge(nn.Module):
    """The parametrization of a target's weight in :func:`lora_view`. The
    adapter is held outside the module tree, so that the view's
    parameters are the frozen base's alone."""

    def __init__(self, adapter: Adapter):
        super().__init__()
        self.__dict__["adapter"] = adapter

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return self.adapter.merged(w)


def frozen(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s tree (every module a shallow copy) whose
    parameters alias its storage with ``requires_grad=False``."""
    new = _shallow(module)
    for k, p in new._parameters.items():
        if p is not None:  # the same storage, no gradient
            new._parameters[k] = nn.Parameter(p.detach(),
                                              requires_grad=False)
    for k, child in new._modules.items():
        if child is not None:
            new._modules[k] = frozen(child)
    return new


def merge_targets(view: nn.Module, lora: LoRA) -> None:
    """Make each target Linear of ``view`` compute its weight, on access,
    as its merge with the adapter (in place)."""
    mods = dict(view.named_modules())
    for name, ad in lora.targets().items():
        parametrize.register_parametrization(mods[name], "weight",
                                             _Merge(ad))


def lora_view(model: nn.Module, lora: LoRA) -> nn.Module:
    """The training forward's model: every parameter an alias of the
    base's storage with ``requires_grad=False``, each target Linear's
    weight computed on access as its merge with the adapter. The base
    model is not changed; gradients reach the adapters only. On a mesh,
    ``parallel/mesh.py:place_lora`` builds the view and places it."""
    view = frozen(model)
    merge_targets(view, lora)
    return view


def whole_lora(lora: LoRA) -> LoRA:
    """The adapters whole: ``lora`` itself, or, for adapters placed on a
    mesh (``place_lora``), a new set gathered from every tensor rank (a
    collective)."""
    placement = getattr(lora, "placement", None)
    if placement is None:
        return lora
    device = next(lora.parameters()).device
    return lora_from_state_dict(placement.full_state_dict(lora), device)


# ------------------------------------------------ the JAX tree's layout


def lora_leaf_map(lora: LoRA) -> Dict[str, JaxLeaf]:
    """Adapter tensor name -> its JAX leaf: ``llm.layers.3.wqkv.A`` is
    layer 3 of ``llm/layers/wqkv_kernel/a`` transposed, ``...B`` of
    ``.../b``; ``...alpha`` is the stacked leaf's one 0-d ``alpha``."""
    out = {}
    names = [n for n, _ in lora.named_parameters()] + \
        [n for n, _ in lora.named_buffers()]
    for name in names:
        *parts, leaf = name.split(".")
        at = parts.index("layers")
        layer = int(parts.pop(at + 1))
        parts[-1] += "_kernel"
        out[name] = JaxLeaf((*parts, leaf.lower()),
                            None if leaf == "alpha" else layer,
                            leaf != "alpha")
    return out


def _adapter_trees(tree, path=()):
    """(path, {"a", "b", "alpha"}) of every adapter in a JAX adapter
    tree."""
    if isinstance(tree, dict) and "a" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _adapter_trees(v, path + (k,))


@torch.no_grad()
def from_jax_lora(tree: dict, cfg=None, device=None) -> LoRA:
    """The port's adapters from a JAX adapter tree (``init_lora`` /
    ``build_lora``'s output, leaves as anything ``np.asarray`` takes): each
    stacked (L, in, r) ``a`` becomes L adapters' ``A`` (r, in), in fp32.
    ``cfg`` is not needed (the shapes carry the layout); it is taken for
    symmetry with ``from_jax_params``."""
    lora = LoRA()
    for path, ad in _adapter_trees(tree):
        tower, stack, kernel = path
        assert stack == "layers" and kernel.endswith("_kernel"), path
        a, b = np.asarray(ad["a"], np.float32), np.asarray(ad["b"],
                                                           np.float32)
        alpha = float(np.asarray(ad["alpha"]))
        for i in range(a.shape[0]):
            r, fan_in, fan_out = a.shape[-1], a.shape[-2], b.shape[-1]
            m = Adapter(r, fan_in, fan_out, alpha, device=device)
            m.A.copy_(torch.from_numpy(np.ascontiguousarray(a[i].T)))
            m.B.copy_(torch.from_numpy(np.ascontiguousarray(b[i].T)))
            lora.add(f"{tower}.layers.{i}.{kernel[:-len('_kernel')]}", m)
    return lora


def lora_from_state_dict(sd: dict, device=None) -> LoRA:
    """Adapters holding a :class:`LoRA` state dict (an adapter checkpoint's
    ``params.pt``): the targets and ranks come from the names and shapes."""
    lora = LoRA()
    natural = lambda n: [int(p) if p.isdigit() else p for p in n.split(".")]
    for name in sorted({k.rsplit(".", 1)[0] for k in sd}, key=natural):
        A, B = sd[name + ".A"], sd[name + ".B"]
        ad = Adapter(A.shape[0], A.shape[1], B.shape[0],
                     float(sd[name + ".alpha"]), device=device,
                     dtype=A.dtype)
        lora.add(name, ad)
    lora.load_state_dict(sd)
    return lora
