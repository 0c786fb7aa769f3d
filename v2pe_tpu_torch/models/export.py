"""Export the port's model back to the HF torch layout (port of
``v2pe_tpu/models/export.py``).

The reverse of ``models/params.py``'s converters: the state dict this
produces uses the key names of the reference's ``modeling_internvl_chat.py``
(the fused interleaved ``wqkv`` for InternLM2; separate q / k / v for qwen2
and llama, fused ``qkv_proj`` and ``gate_up_proj`` for phi3) and
round-trips exactly through ``convert_torch_state_dict``. The port holds
``nn.Linear`` weights as (out, in), HF's own layout, so most entries are
the model's own tensors under another name.

Config and tokenizer files are not synthesized: copy the original HF
checkpoint directory and replace its weights with the exported file
(``python -m v2pe_tpu_torch.tools.export_hf --hf-template`` does that).
"""

from __future__ import annotations

from typing import Dict

import torch

from v2pe_tpu_torch.core.config import VLMConfig
from v2pe_tpu_torch.models.internlm2 import QuantizedInternLM2
from v2pe_tpu_torch.models.params import _LLM, _unpack_qkv, hf_names
from v2pe_tpu_torch.ops.quantized_matmul import (QUANT_WEIGHT_NAMES,
                                                 QuantizedWeight)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


def _dense_llm_state(llm) -> Dict[str, torch.Tensor]:
    """The decoder's state dict under the dense ``InternLM2Model`` names;
    a ``QuantizedInternLM2``'s int8 weights come back dequantized in fp32
    (codes times scales, the padded columns dropped)."""
    if not isinstance(llm, QuantizedInternLM2):
        return llm.state_dict()
    if not isinstance(llm.output, QuantizedWeight):
        raise NotImplementedError("export of an int4 decoder (the JAX "
                                  "package dequantizes int8 weights only)")

    def dequant(w: QuantizedWeight, i=None) -> torch.Tensor:
        q, s = (w.q, w.scale) if i is None else (w.q[i], w.scale[i])
        return (q.float() * s.float())[..., :w.n_out].t()

    sd = {"tok_embeddings.weight": llm.tok_embeddings.weight,
          "norm": llm.norm, "output.weight": dequant(llm.output)}
    for i, layer in enumerate(llm.layers):
        sd[f"layers.{i}.attention_norm"] = layer.attention_norm
        sd[f"layers.{i}.ffn_norm"] = layer.ffn_norm
        for name in QUANT_WEIGHT_NAMES:
            sd[f"layers.{i}.{name}.weight"] = dequant(llm.stacks[name], i)
        for name in ("wqkv", "wo"):
            bias = getattr(layer, name + "_bias")
            if bias is not None:
                sd[f"layers.{i}.{name}.bias"] = bias
    return sd


@torch.no_grad()
def export_torch_state_dict(model, cfg: VLMConfig,
                            lora=None) -> Dict[str, torch.Tensor]:
    """The full InternVLChatModel state dict (HF key names) of the port's
    ``model``: tensors on the model's device in the model's dtype (views of
    its parameters where only the name changes); a quantized decoder's
    weights dequantized in fp32. Round-trips through
    ``convert_torch_state_dict``."""
    if lora is not None:
        raise NotImplementedError("LoRA merge is not ported yet")
    vc, lc = cfg.vision, cfg.llm
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith("llm.")}
    sd.update({"llm." + k: v.detach()
               for k, v in _dense_llm_state(model.llm).items()})
    out = {hf: sd[port] for port, hf in hf_names(cfg).items()}
    emb = "vision_model.embeddings."
    D, P, C = vc.hidden_size, vc.patch_size, vc.num_channels
    out[emb + "class_embedding"] = \
        sd["vision.embeddings.class_embedding"].reshape(1, 1, D)
    out[emb + "patch_embedding.weight"] = \
        sd["vision.embeddings.patch.weight"].reshape(D, C, P, P)
    if lc.arch == "internlm2":
        return out
    for i in range(lc.num_hidden_layers):
        base = f"{_LLM}model.layers.{i}."
        q, k, v = _unpack_qkv(sd[f"llm.layers.{i}.wqkv.weight"], lc)
        if lc.arch == "phi3":
            out[base + "self_attn.qkv_proj.weight"] = torch.cat([q, k, v])
            out[base + "mlp.gate_up_proj.weight"] = torch.cat(
                [sd[f"llm.layers.{i}.w1.weight"],
                 sd[f"llm.layers.{i}.w3.weight"]])
            continue
        for n, t in zip("qkv", (q, k, v)):
            out[base + f"self_attn.{n}_proj.weight"] = t
        if lc.qkv_bias:
            for n, t in zip("qkv", _unpack_qkv(
                    sd[f"llm.layers.{i}.wqkv.bias"], lc)):
                out[base + f"self_attn.{n}_proj.bias"] = t
    return out


def save_safetensors(sd: Dict[str, torch.Tensor], path: str,
                     dtype: str = "bfloat16") -> None:
    """Write an exported state dict as a single HF safetensors file, every
    tensor in ``dtype``, with ``{"format": "pt"}`` metadata (the port's own
    writer, ``models/safetensors_io.py``)."""
    from v2pe_tpu_torch.models import safetensors_io

    td = DTYPES[dtype]
    safetensors_io.save_file({k: v.to(td) for k, v in sd.items()}, path,
                             metadata={"format": "pt"})
