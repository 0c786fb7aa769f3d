"""Random initialization and conversion from the JAX parameter tree (port of
``v2pe_tpu/models/params.py``).

The JAX tree stacks each layer parameter over a leading (L, ...) axis and
stores linears as (in, out) kernels; the port holds one module per layer
and ``nn.Linear`` weights as (out, in).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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


def _jax_state_dict(tree: dict, cfg: VLMConfig) -> dict:
    """The JAX tree's arrays under the port's parameter names."""
    T = np.transpose
    out = {}
    ve, vl = tree["vision"]["embeddings"], tree["vision"]["layers"]
    out["vision.embeddings.class_embedding"] = ve["class_embedding"]
    out["vision.embeddings.patch.weight"] = T(ve["patch_kernel"])
    out["vision.embeddings.patch.bias"] = ve["patch_bias"]
    out["vision.embeddings.position_embedding"] = ve["position_embedding"]
    for i in range(cfg.vision.num_hidden_layers):
        pre = f"vision.layers.{i}."
        for n in ("norm1", "norm2", "norm1_bias", "norm2_bias", "ls1", "ls2",
                  "q_norm", "k_norm"):
            if n in vl:
                out[pre + n] = vl[n][i]
        for n in ("qkv", "proj", "fc1", "fc2"):
            out[pre + n + ".weight"] = T(vl[n + "_kernel"][i])
            if n + "_bias" in vl:
                out[pre + n + ".bias"] = vl[n + "_bias"][i]

    llm, ll = tree["llm"], tree["llm"]["layers"]
    out["llm.tok_embeddings.weight"] = llm["tok_embeddings"]
    out["llm.norm"] = llm["norm"]
    out["llm.output.weight"] = T(llm["output_kernel"])
    for i in range(cfg.llm.num_hidden_layers):
        pre = f"llm.layers.{i}."
        out[pre + "attention_norm"] = ll["attention_norm"][i]
        out[pre + "ffn_norm"] = ll["ffn_norm"][i]
        for n in ("wqkv", "wo", "w1", "w3", "w2"):
            out[pre + n + ".weight"] = T(ll[n + "_kernel"][i])
            if n + "_bias" in ll:
                out[pre + n + ".bias"] = ll[n + "_bias"][i]

    m = tree["mlp1"]
    out["mlp1.ln_weight"] = m["ln_weight"]
    out["mlp1.ln_bias"] = m["ln_bias"]
    for n in ("fc1", "fc2"):
        out[f"mlp1.{n}.weight"] = T(m[n + "_kernel"])
        out[f"mlp1.{n}.bias"] = m[n + "_bias"]
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
