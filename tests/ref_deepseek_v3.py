"""Plain float32 reference of InternVL's front (InternViT + pixel shuffle +
mlp1, scattered into the <IMG_CONTEXT> slots) before the DeepSeek-V3
decoder (Kimi-VL-A3B-Instruct's language model), at V2PE positions,
written from the published architecture (``transformers``'
``models/deepseek_v3/modeling_deepseek_v3.py``).

No kernels, no cache, no batching: one sequence at a time. The weights
are taken one layer at a time from the benchmark's bf16 tensors and
widened to float32; TF32 is off. It imports nothing of the program.

Departures from the published code, each noted:
* latent attention in its published (expanded) form: ``wkv_b`` turns the
  latent into per-head K and V; scores in blocks of 1024 queries;
* the experts one by one, by index, as ``DeepseekV3MoE.moe`` loops; every
  product in float32 (the published layers run in the weights' dtype);
* positions are V2PE's fractional ids (the published model takes integer
  positions), which turn the 64 rotary dims of q and of the shared k;
* the vocabulary head runs only at the positions asked for;
* the router selects in one group (``n_group`` = ``topk_group`` = 1, as
  Kimi-VL publishes); grouped selection is not written.

``fp8=True`` is the control: the same computation with both operands of
every linear product (router and experts included) rounded to float8
e4m3 first (a scale per row of the activations and per output channel of
the weights), the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Weights = Callable[[str], torch.Tensor]
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with a scale per row (last axis), in float32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    def __init__(self, model: dict, weights: Weights, device,
                 fp8: bool = False):
        self.cfg = model
        self.w = weights
        self.dev = device
        self.fp8 = fp8

    def W(self, name: str) -> torch.Tensor:
        return self.w(name).to(device=self.dev, dtype=torch.float32)

    def linear(self, x, name: str, bias: bool = False):
        y = self.mm(x, self.W(name + ".weight"))
        return y + self.W(name + ".bias") if bias else y

    def mm(self, x, w):
        """x w^T, both operands rounded to e4m3 first in the control."""
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return x @ w.t()

    # ------------------------------------------------------------- vision
    def vision(self, pixels: torch.Tensor, block: int = 8) -> torch.Tensor:
        """(T, 3, S, S) -> (T, image tokens, LLM width) float32."""
        return torch.cat([self._vision(pixels[i:i + block])
                          for i in range(0, len(pixels), block)])

    def _vision(self, px: torch.Tensor) -> torch.Tensor:
        v = self.cfg["vision"]
        D, P, H = v["hidden_size"], v["patch_size"], v["num_attention_heads"]
        eps = v["layer_norm_eps"]
        T, C, S, _ = px.shape
        g = S // P
        px = px.to(self.dev, torch.float32)
        patches = px.reshape(T, C, g, P, g, P).permute(0, 2, 4, 1, 3, 5
                                                      ).reshape(T, g * g, -1)
        x = self.linear(patches, "vision.embeddings.patch", bias=True)
        cls = self.W("vision.embeddings.class_embedding").expand(T, 1, D)
        x = torch.cat([cls, x], 1) + self.W(
            "vision.embeddings.position_embedding")
        hd = D // H
        for i in range(v["num_hidden_layers"]):
            p = f"vision.layers.{i}."
            h = F.layer_norm(x, (D,), self.W(p + "norm1"),
                             self.W(p + "norm1_bias"), eps)
            qkv = self.linear(h, p + "qkv", bias=v.get("qkv_bias", True)
                              ).reshape(T, -1, 3, H, hd)
            q, k, vv = (qkv[:, :, j].transpose(1, 2) for j in range(3))
            a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
            o = (a @ vv).transpose(1, 2).reshape(T, -1, D)
            x = x + self.linear(o, p + "proj", bias=True) * self.W(p + "ls1")
            h = F.layer_norm(x, (D,), self.W(p + "norm2"),
                             self.W(p + "norm2_bias"), eps)
            h = F.gelu(self.linear(h, p + "fc1", bias=True))
            x = x + self.linear(h, p + "fc2", bias=True) * self.W(p + "ls2")
        x = x[:, 1:]
        # pixel shuffle (v2) by 1/2: each 2 x 2 patch block becomes one
        # token of 4 D channels
        x = x.reshape(T, g, g // 2, 2 * D).permute(0, 2, 1, 3)
        x = x.reshape(T, g // 2, g // 2, 4 * D).permute(0, 2, 1, 3)
        x = x.reshape(T, -1, 4 * D)
        x = F.layer_norm(x, (4 * D,), self.W("mlp1.ln_weight"),
                         self.W("mlp1.ln_bias"), 1e-5)
        x = F.gelu(self.linear(x, "mlp1.fc1", bias=True))
        return self.linear(x, "mlp1.fc2", bias=True)

    # ---------------------------------------------------------------- LLM
    def embed(self, ids: np.ndarray, context_id: int,
              image_rows: torch.Tensor) -> torch.Tensor:
        ids_t = torch.as_tensor(np.asarray(ids), device=self.dev)
        x = self.w("llm.tok_embeddings.weight")[ids_t.to(
            self.w("llm.tok_embeddings.weight").device)].to(
            self.dev, torch.float32)
        slots = (ids_t == context_id).nonzero()[:, 0]
        if len(slots):
            x[slots] = image_rows.reshape(-1, x.shape[-1])[:len(slots)]
        return x

    def _rms(self, x, name: str, eps: float = None):
        eps = self.cfg["llm"]["rms_norm_eps"] if eps is None else eps
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
            * self.W(name)

    def _rotary(self, pos: np.ndarray, dim: int):
        theta = self.cfg["llm"]["rope_theta"]
        inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        ang = np.asarray(pos, np.float64)[:, None] * inv[None]
        ang = torch.as_tensor(np.concatenate([ang, ang], 1), device=self.dev)
        return torch.cos(ang).float(), torch.sin(ang).float()

    def _rope(self, x, cos, sin):
        """apply_rotary_pos_emb_interleave (rope_interleave): the dims
        de-interleaved (even, then odd), then rotated by halves."""
        if self.cfg["llm"].get("rope_interleave", True):
            d = x.shape[-1]
            x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(
                x.shape)
        half = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin

    def _swiglu(self, h, w1, w3, w2):
        return self.mm(F.silu(self.mm(h, w1)) * self.mm(h, w3), w2)

    def _moe(self, h, p: str):
        """DeepseekV3TopkRouter, then the experts one by one, then the
        shared experts."""
        lc = self.cfg["llm"]
        E, k = lc["n_routed_experts"], lc["num_experts_per_tok"]
        scores = self.mm(h, self.W(p + "gate")).sigmoid()
        choice = scores + self.W(p + "gate_bias")[None]
        idx = torch.topk(choice, k, dim=-1)[1]
        w = scores.gather(1, idx)
        if lc.get("norm_topk_prob", True):
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * lc["routed_scaling_factor"]
        w1, w3 = self.W(p + "experts_w1"), self.W(p + "experts_w3")
        w2 = self.W(p + "experts_w2")
        out = torch.zeros_like(h)
        for e in range(E):
            tok, slot = torch.where(idx == e)
            if len(tok):
                y = self._swiglu(h[tok], w1[e], w3[e], w2[e])
                out.index_add_(0, tok, y * w[tok, slot][:, None])
        del w1, w3, w2
        return out + self._swiglu(h, self.W(p + "shared_w1.weight"),
                                  self.W(p + "shared_w3.weight"),
                                  self.W(p + "shared_w2.weight"))

    def logits_at(self, x: torch.Tensor, pos: np.ndarray,
                  rows: Sequence[int], block: int = 1024) -> torch.Tensor:
        """The DeepSeek-V3 decoder, causal, over one sequence of embeddings
        ``x`` (S, D) at V2PE positions ``pos``: float32 logits
        (len(rows), V) of ``rows``."""
        lc = self.cfg["llm"]
        S, D = x.shape
        H = lc["num_attention_heads"]
        nope, rope = lc["qk_nope_head_dim"], lc["qk_rope_head_dim"]
        R, dv = lc["kv_lora_rank"], lc["v_head_dim"]
        scale = (nope + rope) ** -0.5
        cos, sin = self._rotary(pos, rope)
        for i in range(lc["num_hidden_layers"]):
            p = f"llm.layers.{i}."
            h = self._rms(x, p + "attention_norm")
            q = self.linear(h, p + "wq").view(S, H, nope + rope)
            kv = self.linear(h, p + "wkv_a")
            # kv_a_layernorm keeps DeepseekV3RMSNorm's default eps, 1e-6
            c = self._rms(kv[:, :R], p + "kv_norm", 1e-6)
            k_pe = self._rope(kv[:, R:], cos, sin)                # (S, rope)
            kvb = self.linear(c, p + "wkv_b").view(S, H, nope + dv)
            q = torch.cat([q[..., :nope],
                           self._rope(q[..., nope:], cos[:, None],
                                      sin[:, None])], -1).transpose(0, 1)
            k = torch.cat([kvb[..., :nope],
                           k_pe[:, None].expand(S, H, rope)], -1
                          ).transpose(0, 1)                       # (H, S, .)
            v = kvb[..., nope:].transpose(0, 1)
            del kvb, kv, c
            out = torch.empty((S, H * dv), device=self.dev)
            for a in range(0, S, block):
                b = min(S, a + block)
                s = q[:, a:b] @ k[:, :b].transpose(-1, -2) * scale
                keep = torch.arange(b, device=self.dev)[None] <= \
                    torch.arange(a, b, device=self.dev)[:, None]
                s = s.masked_fill(~keep, float("-inf"))
                out[a:b] = (torch.softmax(s, -1) @ v[:, :b]).transpose(
                    0, 1).reshape(b - a, -1)
            del q, k, v
            x = x + self.linear(out, p + "wo")
            h = self._rms(x, p + "ffn_norm")
            if i < lc["first_k_dense_replace"]:
                x = x + self.linear(F.silu(self.linear(h, p + "w1"))
                                    * self.linear(h, p + "w3"), p + "w2")
            else:
                x = x + self._moe(h, p)
        h = self._rms(x[list(rows)], "llm.norm")
        return self.linear(h, "llm.output")


def served_gaps(ref: Reference, ids: np.ndarray, pos: np.ndarray,
                context_id: int, pixels, served: Sequence[int],
                control: "Reference | None" = None) -> Dict[str, object]:
    """Run the reference once over the prompt ``ids`` and the served
    tokens but the last, and read at each position that produced a served
    token the gap by which that token's logit lies below the reference's
    best. With ``control``, also the gap of the token the control puts
    first at each of those positions. Returns the gaps and the logits of
    the first position (where the first token was sampled)."""
    S = len(ids)
    full = np.concatenate([np.asarray(ids), np.asarray(served[:-1])])
    last = float(pos[-1])
    full_pos = np.concatenate([np.asarray(pos, np.float32),
                               last + np.arange(1, len(served),
                                                dtype=np.float32)])
    rows = list(range(S - 1, S - 1 + len(served)))
    out = {}
    for tag, r in (("ref", ref), ("control", control)):
        if r is None:
            continue
        img = r.vision(torch.as_tensor(pixels)) if pixels is not None \
            else torch.zeros(0, device=r.dev)
        logits = r.logits_at(r.embed(full, context_id, img), full_pos, rows)
        out[tag] = logits
        del img
    want = out["ref"]
    tok = torch.as_tensor(np.asarray(served), device=want.device).long()
    best = want.max(-1).values
    res = {"gaps": (best - want.gather(1, tok[:, None])[:, 0]).cpu(),
           "first": want[0].cpu()}
    if control is not None:
        pick = out["control"].argmax(-1)
        res["control_gaps"] = (best - want.gather(1, pick[:, None])[:, 0]
                               ).cpu()
        res["control_first"] = out["control"][0].cpu()
    return res
