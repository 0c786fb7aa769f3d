"""InternLM2 sequence-classification head (port of
``v2pe_tpu/models/sequence_classification.py``): the reference's
``InternLM2ForSequenceClassification``, a bias-free ``score`` projection of
the hidden state of each row's last non-pad token, with the three HF
problem types (regression MSE, single-label cross-entropy, multi-label
BCE-with-logits). No V2PE training or eval flow uses it; it completes the
reference's public model surface. Its decoder runs through ``llm_forward``,
so its attention is the flash kernel (#1) on the card.

Pooling keeps the reference's quirks: ``pad_token_id is None`` pools the
final token; otherwise the token before the FIRST pad, and a row with no
pad (or a pad at 0) wraps to its last token, as torch's index -1 does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from v2pe_tpu_torch.core.config import LLMConfig
from v2pe_tpu_torch.models.internlm2 import InternLM2Model, llm_forward
from v2pe_tpu_torch.models.params import _as_tensor, _llm_names


class InternLM2ForSequenceClassification(InternLM2Model):
    """The port's ``InternLM2Model`` without its vocab head, plus
    ``score`` (num_labels, D), bias-free."""

    def __init__(self, cfg: LLMConfig, num_labels: int):
        super().__init__(cfg)
        del self.output
        self.score = nn.Linear(cfg.hidden_size, num_labels, bias=False)

    @property
    def num_labels(self) -> int:
        return self.score.out_features


@torch.no_grad()
def init_seq_cls_params(generator: torch.Generator, cfg: LLMConfig,
                        num_labels: int, device=None,
                        dtype=torch.float32
                        ) -> InternLM2ForSequenceClassification:
    """A classifier with the JAX init's scales: linear and embedding
    weights N(0, 0.02), biases 0, norm weights 1, drawn from
    ``generator`` (on ``device``)."""
    with torch.device("meta"):
        model = InternLM2ForSequenceClassification(cfg, num_labels)
    model = model.to_empty(device=device or "cpu").to(dtype).eval()
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif name.endswith("weight"):
            p.normal_(0.0, 0.02, generator=generator)
        else:
            p.fill_(1.0)
    return model


def pool_last_token(x: torch.Tensor, input_ids: torch.Tensor,
                    pad_token_id: Optional[int]) -> torch.Tensor:
    """One position per row of x (B, S, ...): the token before the first
    pad, wrapping to the last token when there is none (or it is at 0)."""
    B, S = input_ids.shape
    if pad_token_id is None:
        idx = torch.full((B,), S - 1, dtype=torch.long, device=x.device)
    else:
        first = torch.argmax((input_ids == pad_token_id).to(torch.int32),
                             dim=-1)
        idx = torch.remainder(first - 1, S)
    return x[torch.arange(B, device=x.device), idx]


def _bce_with_logits(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """The numerically stable BCEWithLogitsLoss, mean reduction."""
    z = torch.clamp(logits, min=0.0) - logits * targets \
        + torch.log1p(torch.exp(-logits.abs()))
    return z.mean()


def resolve_problem_type(num_labels: int, labels: torch.Tensor) -> str:
    """HF's auto-detection."""
    if num_labels == 1:
        return "regression"
    if not labels.is_floating_point():
        return "single_label_classification"
    return "multi_label_classification"


def seq_cls_forward(model: InternLM2ForSequenceClassification,
                    cfg: LLMConfig, *, input_ids: torch.Tensor,
                    labels: Optional[torch.Tensor] = None,
                    pad_token_id: Optional[int] = None,
                    problem_type: Optional[str] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    rope_pos_ids: Optional[torch.Tensor] = None):
    """Returns (pooled logits (B, num_labels) fp32, the loss or None)."""
    hidden, _ = llm_forward(model, cfg, input_ids=input_ids,
                            rope_pos_ids=rope_pos_ids,
                            segment_ids=segment_ids, return_hidden=True)
    logits = hidden.float() @ model.score.weight.float().t()
    pooled = pool_last_token(logits, input_ids, pad_token_id)
    n = model.num_labels
    if labels is None:
        return pooled, None
    pt = problem_type or resolve_problem_type(n, labels)
    if pt == "regression":
        pred = pooled.squeeze() if n == 1 else pooled
        tgt = labels.squeeze() if n == 1 else labels
        loss = ((pred - tgt.float()) ** 2).mean()
    elif pt == "single_label_classification":
        logp = torch.log_softmax(pooled.reshape(-1, n), dim=-1)
        loss = -logp.gather(-1, labels.reshape(-1, 1).long()).mean()
    elif pt == "multi_label_classification":
        loss = _bce_with_logits(pooled, labels.float())
    else:
        raise ValueError(f"unknown problem_type {pt!r}")
    return pooled, loss


def convert_seq_cls_state_dict(sd: dict, lc: LLMConfig,
                               dtype=torch.float32) -> dict:
    """An HF ``InternLM2ForSequenceClassification`` state dict (keys
    ``model.layers.{i}...``, ``model.tok_embeddings.weight``,
    ``model.norm.weight`` and ``score.weight``; tensors or numpy arrays) ->
    the state dict of :class:`InternLM2ForSequenceClassification`, in
    ``dtype``."""
    if lc.arch != "internlm2":
        raise ValueError(f"sequence classification of arch {lc.arch!r}")
    out = {port: _as_tensor(sd[hf]) for port, hf in _llm_names(lc).items()
           if port != "output.weight"}
    out["score.weight"] = _as_tensor(sd["score.weight"])
    return {k: v.to(dtype) for k, v in out.items()}


@torch.no_grad()
def seq_cls_from_jax(tree: dict, cfg: LLMConfig, device=None,
                     dtype=torch.float32
                     ) -> InternLM2ForSequenceClassification:
    """The classifier holding a JAX ``init_seq_cls_params`` tree (leaves as
    anything ``np.asarray`` takes): stacked layers split per layer,
    kernels transposed into the Linear layout."""
    t = lambda a: torch.from_numpy(np.array(np.asarray(a), np.float32))
    sd = {"tok_embeddings.weight": t(tree["tok_embeddings"]),
          "norm": t(tree["norm"]), "score.weight": t(tree["score_kernel"]).t()}
    for name, a in tree["layers"].items():
        for i in range(cfg.num_hidden_layers):
            if name.endswith("_kernel"):
                sd[f"layers.{i}.{name[:-7]}.weight"] = t(a[i]).t()
            elif name.endswith("_bias"):
                sd[f"layers.{i}.{name[:-5]}.bias"] = t(a[i])
            else:  # the norms
                sd[f"layers.{i}.{name}"] = t(a[i])
    model = InternLM2ForSequenceClassification(
        cfg, sd["score.weight"].shape[0])
    model.load_state_dict(sd, strict=True)
    return model.to(device=device or "cpu", dtype=dtype).eval()
