"""Random weights from the seed for a model whose decoder is the DeepSeek-V3
block (latent attention and experts), by ``lib/weights.py``'s rule: one
flat buffer drawn from N(0, 1) by a ``torch.Generator`` on the device in
a few large calls, each leaf's view scaled in place to its kind (matrices,
the token table and the experts N(0, 0.02), norm weights 1 + N(0, 0.02),
biases and the router's correction bias N(0, 0.02), the ViT's class and
position embeddings N(0, 1), LayerScale 0.1). The layout is the port's own
names (``models/deepseek_v3.py``): the ViT and ``mlp1`` as
``lib/weights.py`` lays them out, then per layer ``wq``, ``wkv_a``,
``kv_norm``, ``wkv_b``, ``wo``, and a dense SwiGLU or the router, its bias,
the stacked experts (E, I, D) / (E, D, I) and the shared experts' SwiGLU.
The same seed on the same device gives the same bits."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.lib import weights
from portbench.lib.weights import CHUNK, Leaf, numel


def layout(model: dict) -> List[Leaf]:
    """(name, shape, kind) of every parameter of the model that ``model``
    (the configuration file's ``model`` object) describes."""
    out = [leaf for leaf in weights.layout(model)
           if not leaf[0].startswith("llm.")]
    lc = model["llm"]
    D, V, H = lc["hidden_size"], lc["vocab_size"], lc["num_attention_heads"]
    R, rope = lc["kv_lora_rank"], lc["qk_rope_head_dim"]
    nope, dv = lc["qk_nope_head_dim"], lc["v_head_dim"]
    E, Im = lc["n_routed_experts"], lc["moe_intermediate_size"]
    Is, I = Im * lc["n_shared_experts"], lc["intermediate_size"]
    out.append(("llm.tok_embeddings.weight", (V, D), "matrix"))
    for i in range(lc["num_hidden_layers"]):
        p = f"llm.layers.{i}."
        out += [(p + "attention_norm", (D,), "norm"),
                (p + "ffn_norm", (D,), "norm"),
                (p + "wq.weight", (H * (nope + rope), D), "matrix"),
                (p + "wkv_a.weight", (R + rope, D), "matrix"),
                (p + "kv_norm", (R,), "norm"),
                (p + "wkv_b.weight", (H * (nope + dv), R), "matrix"),
                (p + "wo.weight", (D, H * dv), "matrix")]
        if i < lc["first_k_dense_replace"]:
            out += [(p + "w1.weight", (I, D), "matrix"),
                    (p + "w3.weight", (I, D), "matrix"),
                    (p + "w2.weight", (D, I), "matrix")]
            continue
        out += [(p + "gate", (E, D), "matrix"),
                (p + "gate_bias", (E,), "bias"),
                (p + "experts_w1", (E, Im, D), "matrix"),
                (p + "experts_w3", (E, Im, D), "matrix"),
                (p + "experts_w2", (E, D, Im), "matrix"),
                (p + "shared_w1.weight", (Is, D), "matrix"),
                (p + "shared_w3.weight", (Is, D), "matrix"),
                (p + "shared_w2.weight", (D, Is), "matrix")]
    out += [("llm.norm", (D,), "norm"),
            ("llm.output.weight", (V, D), "matrix")]
    return out


@torch.no_grad()
def make(model: dict, seed: int, device, dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    """name -> a view of one flat buffer, drawn from ``seed``."""
    leaves = layout(model)
    flat = torch.empty(sum(numel(s) for _, s, _ in leaves), dtype=dtype,
                       device=device)
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for chunk in flat.split(CHUNK):
        chunk.normal_(generator=g)
    out, off = {}, 0
    for name, shape, kind in leaves:
        t = flat[off:off + numel(shape)].view(shape)
        off += numel(shape)
        if kind in ("matrix", "bias"):
            t.mul_(0.02)
        elif kind == "norm":
            t.mul_(0.02).add_(1.0)
        elif kind == "scale":
            t.fill_(0.1)
        out[name] = t
    return out
