"""Random initialization, conversion from the JAX parameter tree, and
conversion from HF-layout checkpoints (port of
``v2pe_tpu/models/params.py``).

The JAX tree stacks each layer parameter over a leading (L, ...) axis and
stores linears as (in, out) kernels; the port holds one module per layer
and ``nn.Linear`` weights as (out, in), which is HF's own layout: an HF
state dict maps onto the port's names directly (:func:`hf_names`), and
only the composite-LLM decoders' separate q/k/v (qwen2, llama) or fused
``qkv_proj`` / ``gate_up_proj`` (phi3) are repacked into the interleaved
fused ``wqkv`` and the w1 / w3 pair.

A JAX tree whose ``llm`` went through the JAX package's
``quantize_llm_params`` (leaves with ``.q`` / ``.scale`` or ``.p`` /
``.scale``) becomes a model with a ``QuantizedInternLM2`` decoder: the
stacked codes and scales are the same arrays in the same layout.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.models.internlm2 import InternLM2Model, QuantizedInternLM2
from v2pe_tpu_torch.models.internvl_chat import InternVLChatModel
from v2pe_tpu_torch.ops.quantized_matmul import QUANT_WEIGHT_NAMES


def _meta_model(cfg: VLMConfig, weight_bits: Optional[int] = None,
                group_size: int = 128,
                compress: bool = False) -> InternVLChatModel:
    """The model's structure without storage; with ``weight_bits`` 8 or 4,
    the decoder is a ``QuantizedInternLM2``; with ``compress``, the model
    carries the compress-seq parameters (``models/compress_seq.py``) for
    ``cfg.fuse_method``."""
    with torch.device("meta"):
        model = InternVLChatModel(cfg)
        if weight_bits is not None:
            model.llm = QuantizedInternLM2.empty(cfg.llm, weight_bits,
                                                 group_size)
        if compress:
            from v2pe_tpu_torch.models.compress_seq import Compress

            model.compress = Compress(cfg.llm, cfg.fuse_method)
    return model


def _empty_model(cfg: VLMConfig, device, dtype,
                 weight_bits: Optional[int] = None,
                 group_size: int = 128,
                 compress: bool = False) -> InternVLChatModel:
    # built on the meta device: no time spent on initializers whose values
    # are overwritten next
    model = _meta_model(cfg, weight_bits, group_size, compress)
    return model.to_empty(device=device or "cpu").to(dtype).eval()


def _placed(model: InternVLChatModel, cfg: VLMConfig, mesh):
    """``model`` placed on ``mesh`` (a ``ShardingContext`` whose mesh spans
    processes): each rank keeps its shard of the whole weights it was
    given (``parallel/mesh.py:shard_model``); None leaves it whole."""
    if mesh is None:
        return model
    from v2pe_tpu_torch.parallel.mesh import shard_model

    return shard_model(model, cfg, mesh)


@torch.no_grad()
def init_vlm_params(cfg: VLMConfig, generator: torch.Generator,
                    device=None, dtype=torch.float32,
                    mesh=None) -> InternVLChatModel:
    """A model with the JAX init's shapes and scales: linear and embedding
    weights N(0, 0.02), class and position embeddings N(0, 1), biases 0,
    norm weights 1, LayerScale ``initializer_factor``. Draws come from
    ``generator``, which must live on ``device``. With ``mesh`` (a
    ``ShardingContext``) each rank draws the whole weights from its own
    generator (seed them alike) and keeps its shard."""
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
    return _placed(model, cfg, mesh)


class JaxLeaf(NamedTuple):
    """Where a port parameter lives in the JAX tree: the leaf's path, the
    index on its stacked (L, ...) axis (None for a leaf that is not
    stacked), and whether the port holds it transposed (an ``nn.Linear``
    weight (out, in) against a JAX kernel (in, out))."""

    path: Tuple[str, ...]
    layer: Optional[int]
    transposed: bool


def jax_leaf_map(cfg: VLMConfig, weight_bits: Optional[int] = None,
                 compress: Optional[bool] = None) -> Dict[str, JaxLeaf]:
    """Port parameter name -> its JAX leaf, for every parameter of the
    port's model. Linear weights map to ``<name>_kernel``, their biases to
    ``<name>_bias``, an embedding table to the module's name; ``layers.<i>``
    becomes index i of the stacked leaf. With ``weight_bits`` 8 or 4 the
    decoder is quantized, and the map also names its buffers:
    ``llm.stacks.<name>.<q|p|scale>`` is the whole stacked child of the
    quantized leaf ``llm/layers/<name>_kernel``, ``llm.output.<...>`` of
    ``llm/output_kernel``. With ``compress`` (default:
    ``cfg.compress_seq``) the map also holds the compress-seq parameters:
    ``compress.layer_scale`` is ``compress/layer_scale``,
    ``compress.interaction.<i>.wqkv.weight`` index i of
    ``compress/interaction/wqkv_kernel``, ``compress.fuse.<i>.wq.weight``
    of ``compress/fuse/wq_kernel``."""
    if compress is None:
        compress = cfg.compress_seq
    model = _meta_model(cfg, weight_bits, compress=compress)
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
        elif parts[0] == "compress" and len(parts) > 2 \
                and parts[2].isdigit():
            layer = int(parts.pop(2))
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
            cfg, weight_bits, compress="compress" in tree).items():
        a = tree
        for key in path:  # a dict's key, or a quantized leaf's child
            a = a[key] if isinstance(a, dict) else getattr(a, key)
        if layer is not None:
            a = a[layer]
        out[name] = np.transpose(a) if transposed else a
    return out


@torch.no_grad()
def from_jax_params(tree: dict, cfg: VLMConfig, device=None,
                    dtype: Optional[torch.dtype] = None,
                    mesh=None) -> InternVLChatModel:
    """Build the port's model from the JAX parameter tree (leaves as numpy
    arrays or anything ``np.asarray`` takes), in ``dtype`` (float32 by
    default). A tree with a quantized ``llm`` gives a quantized decoder
    with the same codes and scales; a tree with ``compress`` (the JAX
    ``init_compress_params``) gives the model its ``compress`` module.
    With ``mesh`` (a ``ShardingContext``) each rank keeps its shard of the
    tree's weights (every rank passes the same tree)."""
    head = tree["llm"]["output_kernel"]
    bits = 8 if hasattr(head, "q") else 4 if hasattr(head, "p") else None
    group_size = getattr(head, "group_size", 128)

    def tensor(v):  # a writable copy; codes stay int8
        a = np.asarray(v)
        return torch.from_numpy(np.array(
            a, np.int8 if a.dtype == np.int8 else np.float32))

    sd = {k: tensor(v) for k, v in _jax_state_dict(tree, cfg, bits).items()}
    model = _empty_model(cfg, device, dtype or torch.float32, bits,
                         group_size, compress="compress" in tree)
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
    return _placed(model, cfg, mesh)


# --------------------------------------------------------------------------
# HF (torch) state dicts and safetensors checkpoints
# --------------------------------------------------------------------------

_VIT_LAYER = {  # port name in a ViT layer -> HF name
    "norm1": "norm1.weight", "norm1_bias": "norm1.bias",
    "norm2": "norm2.weight", "norm2_bias": "norm2.bias",
    "ls1": "ls1", "ls2": "ls2",
    "qkv.weight": "attn.qkv.weight", "qkv.bias": "attn.qkv.bias",
    "q_norm": "attn.q_norm.weight", "k_norm": "attn.k_norm.weight",
    "proj.weight": "attn.proj.weight", "proj.bias": "attn.proj.bias",
    "fc1.weight": "mlp.fc1.weight", "fc1.bias": "mlp.fc1.bias",
    "fc2.weight": "mlp.fc2.weight", "fc2.bias": "mlp.fc2.bias"}
_INTERNLM2_LAYER = {
    "attention_norm": "attention_norm.weight", "ffn_norm": "ffn_norm.weight",
    "wqkv.weight": "attention.wqkv.weight",
    "wqkv.bias": "attention.wqkv.bias",
    "wo.weight": "attention.wo.weight", "wo.bias": "attention.wo.bias",
    "w1.weight": "feed_forward.w1.weight",
    "w3.weight": "feed_forward.w3.weight",
    "w2.weight": "feed_forward.w2.weight"}
_LLAMA_LAYER = {  # qwen2 / llama / phi3 (HF llama-style module names)
    "attention_norm": "input_layernorm.weight",
    "ffn_norm": "post_attention_layernorm.weight",
    "wo.weight": "self_attn.o_proj.weight",
    "w1.weight": "mlp.gate_proj.weight", "w3.weight": "mlp.up_proj.weight",
    "w2.weight": "mlp.down_proj.weight"}
_MLP1 = {"mlp1.ln_weight": "mlp1.0.weight", "mlp1.ln_bias": "mlp1.0.bias",
         "mlp1.fc1.weight": "mlp1.1.weight", "mlp1.fc1.bias": "mlp1.1.bias",
         "mlp1.fc2.weight": "mlp1.3.weight", "mlp1.fc2.bias": "mlp1.3.bias"}
_LLM = "language_model."


def _check_arch(lc) -> None:
    if lc.arch == "qwen2":
        ok = lc.qkv_bias and not lc.bias
        why = "qwen2 biases q/k/v but not o_proj (qkv_bias=True, bias=False)"
    elif lc.arch in ("llama", "phi3"):
        ok = not lc.qkv_bias and not lc.bias
        why = f"{lc.arch} has no biases (qkv_bias=False, bias=False)"
    else:
        ok, why = lc.arch == "internlm2", f"unknown llm arch {lc.arch!r}"
    if not ok:
        raise ValueError(why)


def _names(module: nn.Module, table: Dict[str, str]) -> Dict[str, str]:
    """``table`` restricted to the parameters ``module`` has."""
    have = set(module.state_dict())
    return {k: v for k, v in table.items() if k in have}


def _llm_names(lc) -> Dict[str, str]:
    """:func:`hf_names` for the decoder alone: names without ``llm.``, HF
    names without ``language_model.``."""
    _check_arch(lc)
    internlm2 = lc.arch == "internlm2"
    layer = _INTERNLM2_LAYER if internlm2 else dict(_LLAMA_LAYER)
    if lc.arch == "phi3":
        del layer["w1.weight"], layer["w3.weight"]
    out = {f"layers.{i}.{port}": f"model.layers.{i}.{hf}"
           for i in range(lc.num_hidden_layers) for port, hf in layer.items()}
    out["norm"] = "model.norm.weight"
    out["tok_embeddings.weight"] = "model.tok_embeddings.weight" \
        if internlm2 else "model.embed_tokens.weight"
    out["output.weight"] = "output.weight" if internlm2 else "lm_head.weight"
    with torch.device("meta"):
        return _names(InternLM2Model(lc), out)


def hf_names(cfg: VLMConfig) -> Dict[str, str]:
    """Port parameter name -> HF name, for every parameter of the dense
    model of ``cfg`` that is an HF tensor as it is. Left out are the ones
    that change shape or are made of several HF tensors: the class
    embedding ((1, 1, D) in HF), the patch embedding ((D, C, P, P) in HF)
    and, for qwen2 / llama / phi3, ``wqkv`` (for phi3 also ``w1`` /
    ``w3``)."""
    table = {"vision.embeddings.patch.bias":
             "vision_model.embeddings.patch_embedding.bias",
             "vision.embeddings.position_embedding":
             "vision_model.embeddings.position_embedding", **_MLP1}
    for i in range(cfg.vision.num_hidden_layers):
        for port, hf in _VIT_LAYER.items():
            table[f"vision.layers.{i}.{port}"] = \
                f"vision_model.encoder.layers.{i}.{hf}"
    out = _names(_meta_model(cfg), table)
    out.update({"llm." + k: _LLM + v for k, v in _llm_names(cfg.llm).items()})
    return out


def _repack_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lc):
    """HF's separate q / k / v rows -> the interleaved fused ``wqkv`` rows:
    per kv head, its G query heads, then its k head, then its v head
    (``split_wqkv``'s layout). Weights (rows, D) or biases (rows,)."""
    Hkv, hd, G = lc.num_key_value_heads, lc.head_dim, lc.num_key_value_groups
    tail = q.shape[1:]
    return torch.cat([q.reshape(Hkv, G, hd, *tail),
                      k.reshape(Hkv, 1, hd, *tail),
                      v.reshape(Hkv, 1, hd, *tail)], dim=1).reshape(
                          -1, *tail)


def _unpack_qkv(w: torch.Tensor, lc):
    """The inverse of :func:`_repack_qkv`: (q, k, v) rows."""
    Hkv, hd, G = lc.num_key_value_heads, lc.head_dim, lc.num_key_value_groups
    tail = w.shape[1:]
    w = w.reshape(Hkv, G + 2, hd, *tail)
    return (w[:, :G].reshape(-1, *tail), w[:, G].reshape(-1, *tail),
            w[:, G + 1].reshape(-1, *tail))


def _as_tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def convert_qwen2_llm(sd: dict, lc, prefix: str = "") -> dict:
    """An HF Qwen2ForCausalLM or LlamaForCausalLM state dict (llama: no
    qkv bias) -> the port's decoder state dict (``InternLM2Model`` names):
    q / k / v repacked into the interleaved fused ``wqkv`` (and their
    biases for qwen2), everything else renamed. ``prefix``: '' for a bare
    ``*ForCausalLM``, 'language_model.' inside an InternVLChatModel. A
    checkpoint without ``lm_head.weight`` ties the head to the embedding
    (a copy)."""
    if lc.arch not in ("qwen2", "llama"):
        raise ValueError(f"convert_qwen2_llm: arch {lc.arch!r}")
    return _convert_llm(sd, lc, prefix)


def convert_phi3_llm(sd: dict, lc, prefix: str = "") -> dict:
    """An HF Phi3ForCausalLM state dict -> the port's decoder state dict:
    ``qkv_proj`` ([q; k; v] concatenated) split and repacked into the
    interleaved ``wqkv``, ``gate_up_proj`` split into w1 and w3.
    Long-context 'su' / longrope scaling is not converted."""
    if lc.arch != "phi3":
        raise ValueError(f"convert_phi3_llm: arch {lc.arch!r}")
    return _convert_llm(sd, lc, prefix)


def _convert_llm(sd: dict, lc, prefix: str) -> dict:
    """The ``llm.`` part of :func:`convert_torch_state_dict` without the
    ``llm.`` prefix, read from ``sd`` under ``prefix``."""
    out = {}
    for port, hf in _llm_names(lc).items():
        if port == "output.weight" and prefix + hf not in sd:
            continue  # tied, below
        out[port] = _as_tensor(sd[prefix + hf])
    if "output.weight" not in out:
        out["output.weight"] = out["tok_embeddings.weight"].clone()
    if lc.arch == "internlm2":
        return out
    Hq, Hkv, hd = lc.num_attention_heads, lc.num_key_value_heads, lc.head_dim
    I = lc.intermediate_size
    for i in range(lc.num_hidden_layers):
        base = f"{prefix}model.layers.{i}."
        if lc.arch == "phi3":
            w = _as_tensor(sd[base + "self_attn.qkv_proj.weight"])
            qkv = [w[:Hq * hd], w[Hq * hd:(Hq + Hkv) * hd],
                   w[(Hq + Hkv) * hd:]]
            gu = _as_tensor(sd[base + "mlp.gate_up_proj.weight"])
            out[f"layers.{i}.w1.weight"] = gu[:I]
            out[f"layers.{i}.w3.weight"] = gu[I:]
        else:
            qkv = [_as_tensor(sd[base + f"self_attn.{n}_proj.weight"])
                   for n in "qkv"]
        out[f"layers.{i}.wqkv.weight"] = _repack_qkv(*qkv, lc)
        if lc.qkv_bias:
            out[f"layers.{i}.wqkv.bias"] = _repack_qkv(
                *[_as_tensor(sd[base + f"self_attn.{n}_proj.bias"])
                  for n in "qkv"], lc)
    return out


def convert_torch_state_dict(sd: dict, cfg: VLMConfig,
                             dtype: Optional[torch.dtype] = None) -> dict:
    """An InternVLChatModel state dict in HF layout and names (tensors or
    numpy arrays) -> the port's state dict, every entry of the dense model
    of ``cfg`` (``KeyError`` for one the checkpoint lacks). Tensors keep
    their dtype unless ``dtype`` is given, and are views of ``sd``'s where
    only the name or the shape changes."""
    vc = cfg.vision
    names = hf_names(cfg)
    out = {port: _as_tensor(sd[hf]) for port, hf in names.items()
           if not port.startswith("llm.")}
    emb = "vision_model.embeddings."
    out["vision.embeddings.class_embedding"] = _as_tensor(
        sd[emb + "class_embedding"]).reshape(-1)
    out["vision.embeddings.patch.weight"] = _as_tensor(
        sd[emb + "patch_embedding.weight"]).reshape(vc.hidden_size, -1)
    out.update({"llm." + k: v
                for k, v in _convert_llm(sd, cfg.llm, _LLM).items()})
    order = list(_meta_model(cfg).state_dict())
    if set(order) != set(out):
        raise KeyError(f"state dict names differ from the model's: "
                       f"{sorted(set(order) ^ set(out))[:8]}")
    return {k: out[k] if dtype is None else out[k].to(dtype)
            for k in order}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: no CUDA device is "
                           f"available; pass device='cpu' to load onto the "
                           f"CPU")
    return device


@torch.no_grad()
def model_from_state_dict(sd: dict, cfg: VLMConfig, device="cuda",
                          dtype: Optional[torch.dtype] = None
                          ) -> InternVLChatModel:
    """The dense model of ``cfg`` holding ``sd`` (the port's names), each
    tensor copied once onto ``device`` in ``dtype`` (default: its own);
    with the compress-seq module when ``sd`` holds ``compress.*``."""
    device = _device(device)
    model = _meta_model(cfg, compress=any(k.startswith("compress.")
                                          for k in sd))
    model.load_state_dict(
        {k: v.to(device=device, dtype=dtype or v.dtype, copy=True)
         for k, v in sd.items()}, strict=True, assign=True)
    return model.eval()


def load_safetensors_checkpoint(path: str, cfg: VLMConfig,
                                dtype: Optional[torch.dtype] = None,
                                device="cuda") -> InternVLChatModel:
    """The model of an HF safetensors checkpoint directory (every
    ``*.safetensors`` file in it, sorted), on ``device`` (the CUDA card by
    default; it raises where there is none), in the checkpoint's dtype
    unless ``dtype`` is given. Read with the port's own reader
    (``models/safetensors_io.py``), which takes bf16 files."""
    from v2pe_tpu_torch.models import safetensors_io

    device = _device(device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    sd = convert_torch_state_dict(safetensors_io.load_dir(path), cfg)
    return model_from_state_dict(sd, cfg, device, dtype)
