"""Random initialization and conversion from the JAX parameter tree (port of
``v2pe_tpu/models/params.py``).

The JAX tree stacks each layer parameter over a leading (L, ...) axis and
stores linears as (in, out) kernels; the port holds one module per layer
and ``nn.Linear`` weights as (out, in).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from v2pe_tpu.core.config import VLMConfig
from v2pe_tpu_torch.models.internvl_chat import InternVLChatModel


def _empty_model(cfg: VLMConfig, device, dtype) -> InternVLChatModel:
    # built on the meta device: no time spent on initializers whose values
    # are overwritten next
    with torch.device("meta"):
        model = InternVLChatModel(cfg)
    return model.to_empty(device=device or "cpu").to(dtype).eval()


@torch.no_grad()
def init_vlm_params(cfg: VLMConfig, generator: torch.Generator,
                    device=None, dtype=torch.float32) -> InternVLChatModel:
    """A model with the JAX init's shapes and scales: linear and embedding
    weights N(0, 0.02), class and position embeddings N(0, 1), biases 0,
    norm weights 1, LayerScale ``initializer_factor``. Draws come from
    ``generator``, which must live on ``device``."""
    model = _empty_model(cfg, device, dtype)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("class_embedding", "position_embedding"):
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf in ("ls1", "ls2"):
            p.fill_(cfg.vision.initializer_factor)
        elif leaf == "bias" or leaf.endswith("_bias"):
            p.zero_()
        elif leaf == "weight":
            p.normal_(0.0, 0.02, generator=generator)
        else:  # RMSNorm / LayerNorm weights
            p.fill_(1.0)
    return model


class JaxLeaf(NamedTuple):
    """Where a port parameter lives in the JAX tree: the leaf's path, the
    index on its stacked (L, ...) axis (None for a leaf that is not
    stacked), and whether the port holds it transposed (an ``nn.Linear``
    weight (out, in) against a JAX kernel (in, out))."""

    path: Tuple[str, ...]
    layer: Optional[int]
    transposed: bool


def jax_leaf_map(cfg: VLMConfig) -> Dict[str, JaxLeaf]:
    """Port parameter name -> its JAX leaf, for every parameter of the
    port's model. Linear weights map to ``<name>_kernel``, their biases to
    ``<name>_bias``, an embedding table to the module's name; ``layers.<i>``
    becomes index i of the stacked leaf."""
    with torch.device("meta"):
        model = InternVLChatModel(cfg)
    modules = dict(model.named_modules())
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        layer = None
        if "layers" in parts:
            at = parts.index("layers")
            layer = int(parts.pop(at + 1))
        owner = modules[name.rsplit(".", 1)[0]]
        transposed = False
        if isinstance(owner, nn.Linear):
            leaf = parts.pop(-1)
            transposed = leaf == "weight"
            parts[-1] += "_kernel" if transposed else "_bias"
        elif isinstance(owner, nn.Embedding):
            parts.pop(-1)
        out[name] = JaxLeaf(tuple(parts), layer, transposed)
    return out


def _jax_state_dict(tree: dict, cfg: VLMConfig) -> dict:
    """The arrays of a tree shaped like the JAX parameters (the parameters,
    their gradients, optimizer moments) under the port's names and in its
    layouts."""
    out = {}
    for name, (path, layer, transposed) in jax_leaf_map(cfg).items():
        a = tree
        for key in path:
            a = a[key]
        if layer is not None:
            a = a[layer]
        out[name] = np.transpose(a) if transposed else a
    return out


@torch.no_grad()
def from_jax_params(tree: dict, cfg: VLMConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> InternVLChatModel:
    """Build the port's model from the JAX parameter tree (leaves as numpy
    arrays or anything ``np.asarray`` takes), in ``dtype`` (float32 by
    default)."""
    sd = {k: torch.from_numpy(np.array(v, np.float32))  # a writable copy
          for k, v in _jax_state_dict(tree, cfg).items()}
    model = _empty_model(cfg, device, dtype or torch.float32)
    model.load_state_dict(sd, strict=True)
    return model
