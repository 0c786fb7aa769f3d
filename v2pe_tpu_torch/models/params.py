"""Random initialization and conversion from the JAX parameter tree (port of
``v2pe_tpu/models/params.py``).

The JAX tree stacks each layer parameter over a leading (L, ...) axis and
stores linears as (in, out) kernels; the port holds one module per layer
and ``nn.Linear`` weights as (out, in).

A JAX tree whose ``llm`` went through the JAX package's
``quantize_llm_params`` (leaves with ``.q`` / ``.scale`` or ``.p`` /
``.scale``) becomes a model with a ``QuantizedInternLM2`` decoder: the
stacked codes and scales are the same arrays in the same layout.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.models.internlm2 import QuantizedInternLM2
from v2pe_tpu_torch.models.internvl_chat import InternVLChatModel
from v2pe_tpu_torch.ops.quantized_matmul import QUANT_WEIGHT_NAMES


def _meta_model(cfg: VLMConfig, weight_bits: Optional[int] = None,
                group_size: int = 128) -> InternVLChatModel:
    """The model's structure without storage; with ``weight_bits`` 8 or 4,
    the decoder is a ``QuantizedInternLM2``."""
    with torch.device("meta"):
        model = InternVLChatModel(cfg)
        if weight_bits is not None:
            model.llm = QuantizedInternLM2.empty(cfg.llm, weight_bits,
                                                 group_size)
    return model


def _empty_model(cfg: VLMConfig, device, dtype,
                 weight_bits: Optional[int] = None,
                 group_size: int = 128) -> InternVLChatModel:
    # built on the meta device: no time spent on initializers whose values
    # are overwritten next
    model = _meta_model(cfg, weight_bits, group_size)
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


def jax_leaf_map(cfg: VLMConfig, weight_bits: Optional[int] = None
                 ) -> Dict[str, JaxLeaf]:
    """Port parameter name -> its JAX leaf, for every parameter of the
    port's model. Linear weights map to ``<name>_kernel``, their biases to
    ``<name>_bias``, an embedding table to the module's name; ``layers.<i>``
    becomes index i of the stacked leaf. With ``weight_bits`` 8 or 4 the
    decoder is quantized, and the map also names its buffers:
    ``llm.stacks.<name>.<q|p|scale>`` is the whole stacked child of the
    quantized leaf ``llm/layers/<name>_kernel``, ``llm.output.<...>`` of
    ``llm/output_kernel``."""
    model = _meta_model(cfg, weight_bits)
    modules = dict(model.named_modules())
    out = {}
    if weight_bits is not None:
        for name, _ in model.llm.named_buffers():
            *owner, child = name.split(".")
            leaf = ("output_kernel",) if owner == ["output"] else \
                ("layers", owner[-1] + "_kernel")
            assert owner == ["output"] or owner[-1] in QUANT_WEIGHT_NAMES
            out["llm." + name] = JaxLeaf(("llm", *leaf, child), None, False)
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


def _jax_state_dict(tree: dict, cfg: VLMConfig,
                    weight_bits: Optional[int] = None) -> dict:
    """The arrays of a tree shaped like the JAX parameters (the parameters,
    their gradients, optimizer moments) under the port's names and in its
    layouts."""
    out = {}
    for name, (path, layer, transposed) in jax_leaf_map(
            cfg, weight_bits).items():
        a = tree
        for key in path:  # a dict's key, or a quantized leaf's child
            a = a[key] if isinstance(a, dict) else getattr(a, key)
        if layer is not None:
            a = a[layer]
        out[name] = np.transpose(a) if transposed else a
    return out


@torch.no_grad()
def from_jax_params(tree: dict, cfg: VLMConfig, device=None,
                    dtype: Optional[torch.dtype] = None) -> InternVLChatModel:
    """Build the port's model from the JAX parameter tree (leaves as numpy
    arrays or anything ``np.asarray`` takes), in ``dtype`` (float32 by
    default). A tree with a quantized ``llm`` gives a quantized decoder
    with the same codes and scales."""
    head = tree["llm"]["output_kernel"]
    bits = 8 if hasattr(head, "q") else 4 if hasattr(head, "p") else None
    group_size = getattr(head, "group_size", 128)

    def tensor(v):  # a writable copy; codes stay int8
        a = np.asarray(v)
        return torch.from_numpy(np.array(
            a, np.int8 if a.dtype == np.int8 else np.float32))

    sd = {k: tensor(v) for k, v in _jax_state_dict(tree, cfg, bits).items()}
    model = _empty_model(cfg, device, dtype or torch.float32, bits,
                         group_size)
    model.load_state_dict(sd, strict=True)
    if bits is not None:
        pairs = [(model.llm.output, head)] + [
            (model.llm.stacks[n], tree["llm"]["layers"][n + "_kernel"])
            for n in QUANT_WEIGHT_NAMES]
        for ours, theirs in pairs:
            for attr in ("n_out", "group_size")[:1 if bits == 8 else 2]:
                if getattr(ours, attr) != getattr(theirs, attr):
                    raise ValueError(
                        f"{attr}: the tree has {getattr(theirs, attr)}, the "
                        f"port's layout {getattr(ours, attr)}")
    return model
