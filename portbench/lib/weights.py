"""Random weights from the seed, made on the device in the served type.

The benchmark makes the weights, not the program: one flat buffer drawn
from N(0, 1) by a ``torch.Generator`` on the device in a few large calls,
then each leaf's view scaled in place to its kind (matrices and the token
table N(0, 0.02), the ViT's class and position embeddings N(0, 1),
LayerScale 0.1, norm weights 1 + N(0, 0.02), biases N(0, 0.02)). The
layout is InternVL's published one (HF names, ``nn.Linear`` weights as
(out, in), InternLM2's fused ``wqkv`` interleaved per kv head as G query
heads, then k, then v). The same seed on the same device gives the same
bits, so the reference draws them again after the program has gone."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]
CHUNK = 1 << 28  # elements a draw


def layout(model: dict) -> List[Leaf]:
    """(name, shape, kind) of every parameter of the InternVL model that
    ``model`` (the configuration file's ``model`` object) describes."""
    v, lc = model["vision"], model["llm"]
    D, I, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n_pos = (v["image_size"] // P) ** 2 + 1
    out: List[Leaf] = [
        ("vision.embeddings.class_embedding", (D,), "unit"),
        ("vision.embeddings.position_embedding", (1, n_pos, D), "unit"),
        ("vision.embeddings.patch.weight", (D, v["num_channels"] * P * P),
         "matrix"),
        ("vision.embeddings.patch.bias", (D,), "bias"),
    ]
    for i in range(v["num_hidden_layers"]):
        p = f"vision.layers.{i}."
        out += [(p + "norm1", (D,), "norm"), (p + "norm2", (D,), "norm"),
                (p + "norm1_bias", (D,), "bias"),
                (p + "norm2_bias", (D,), "bias"),
                (p + "ls1", (D,), "scale"), (p + "ls2", (D,), "scale"),
                (p + "qkv.weight", (3 * D, D), "matrix")]
        if v.get("qkv_bias", True):
            out.append((p + "qkv.bias", (3 * D,), "bias"))
        out += [(p + "proj.weight", (D, D), "matrix"),
                (p + "proj.bias", (D,), "bias"),
                (p + "fc1.weight", (I, D), "matrix"),
                (p + "fc1.bias", (I,), "bias"),
                (p + "fc2.weight", (D, I), "matrix"),
                (p + "fc2.bias", (D,), "bias")]
    Dl, Il, V = lc["hidden_size"], lc["intermediate_size"], lc["vocab_size"]
    Hq, Hkv = lc["num_attention_heads"], lc["num_key_value_heads"]
    hd = Dl // Hq
    out.append(("llm.tok_embeddings.weight", (V, Dl), "matrix"))
    for i in range(lc["num_hidden_layers"]):
        p = f"llm.layers.{i}."
        out += [(p + "attention_norm", (Dl,), "norm"),
                (p + "ffn_norm", (Dl,), "norm"),
                (p + "wqkv.weight", ((Hq + 2 * Hkv) * hd, Dl), "matrix")]
        if lc.get("bias") or lc.get("qkv_bias"):
            out.append((p + "wqkv.bias", ((Hq + 2 * Hkv) * hd,), "bias"))
        out.append((p + "wo.weight", (Dl, Hq * hd), "matrix"))
        if lc.get("bias"):
            out.append((p + "wo.bias", (Dl,), "bias"))
        out += [(p + "w1.weight", (Il, Dl), "matrix"),
                (p + "w3.weight", (Il, Dl), "matrix"),
                (p + "w2.weight", (Dl, Il), "matrix")]
    out += [("llm.norm", (Dl,), "norm"),
            ("llm.output.weight", (V, Dl), "matrix")]
    Dv = D * int(round(1 / model.get("downsample_ratio", 0.5))) ** 2
    out += [("mlp1.ln_weight", (Dv,), "norm"), ("mlp1.ln_bias", (Dv,), "bias"),
            ("mlp1.fc1.weight", (Dl, Dv), "matrix"),
            ("mlp1.fc1.bias", (Dl,), "bias"),
            ("mlp1.fc2.weight", (Dl, Dl), "matrix"),
            ("mlp1.fc2.bias", (Dl,), "bias")]
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


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
