"""Long-VQA (32k-64k document/chart QA) scorers.

Parity: ``eval/longvqa/calculate_scores.py`` (metric dispatch per task
:28-46, relaxed accuracy :48-76), due_evaluator's ANLS, textvqa_evaluator's
consensus VQA accuracy, plus EACC (exact), F1 over token sets, and BLEU4 /
WTQ handled as normalized exact-match fallbacks."""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from v2pe_tpu_torch.evalkit.metrics import anls, relaxed_accuracy


def decide_metric(task: str) -> str:
    if task in ["chartqa", "clevr", "dvqa", "gqa", "ocrvqa"]:
        return "RACC"
    if task in ["svqa", "tabfact"]:
        return "EACC"
    if task in ["deepform", "kleistercharity"]:
        return "F1"
    if task in ["docvqa", "infovqa"]:
        return "ANLS"
    if task in ["okvqa", "textvqa", "vizwiz"]:
        return "TEXTVQA"
    if task in ["textcaps", "visualmrc"]:
        return "BLEU4"
    if task in ["wikitablequestions"]:
        return "WTQ"
    return "RACC"


def _norm(text: str) -> str:
    return " ".join(str(text).strip().lower().split())


def vqa_consensus_accuracy(prediction: str,
                           annotations: Sequence[str]) -> float:
    """TextVQA/VQAv2 consensus: min(#matching-annotators / 3, 1)."""
    pred = _norm(prediction)
    matches = sum(_norm(a) == pred for a in annotations)
    return min(matches / 3.0, 1.0)


def token_f1(prediction: str, target: str) -> float:
    p = _norm(prediction).split()
    t = _norm(target).split()
    if not p or not t:
        return float(p == t)
    common = Counter(p) & Counter(t)
    overlap = sum(common.values())
    if overlap == 0:
        return 0.0
    precision = overlap / len(p)
    recall = overlap / len(t)
    return 2 * precision * recall / (precision + recall)


def bleu4(prediction: str, target: str) -> float:
    """Sentence BLEU-4 with uniform weights and brevity penalty."""
    p = _norm(prediction).split()
    t = _norm(target).split()
    if not p:
        return 0.0
    precisions = []
    for n in range(1, 5):
        pn = Counter(tuple(p[i:i + n]) for i in range(len(p) - n + 1))
        tn = Counter(tuple(t[i:i + n]) for i in range(len(t) - n + 1))
        overlap = sum((pn & tn).values())
        total = max(sum(pn.values()), 1)
        precisions.append(max(overlap, 1e-9) / total)
    bp = 1.0 if len(p) > len(t) else float(np.exp(1 - len(t) / len(p)))
    return bp * float(np.exp(np.mean(np.log(precisions))))


def score_entry(metric: str, prediction: str, annotations) -> float:
    if isinstance(annotations, str):
        annotations = [annotations]
    annotations = [str(a) for a in annotations]
    if metric == "RACC":
        return float(max(relaxed_accuracy(str(prediction).strip(), a)
                         for a in annotations))
    if metric == "EACC":
        return float(any(_norm(prediction) == _norm(a)
                         for a in annotations))
    if metric == "ANLS":
        return anls(prediction, annotations)
    if metric == "TEXTVQA":
        return vqa_consensus_accuracy(prediction, annotations)
    if metric == "F1":
        return max(token_f1(prediction, a) for a in annotations)
    if metric in ("BLEU4",):
        return max(bleu4(prediction, a) for a in annotations)
    if metric == "WTQ":
        return float(any(_norm(prediction) == _norm(a)
                         for a in annotations))
    raise NotImplementedError(metric)


def score_task(task: str, entries: List[dict]) -> dict:
    """entries: [{'answer': model output, 'annotation': gt(s)}] like the
    reference's rectified outputs."""
    metric = decide_metric(task)
    scores = [score_entry(metric, e["answer"], e["annotation"])
              for e in entries]
    return {"task": task, "metric": metric,
            "score": float(np.mean(scores)) if scores else 0.0,
            "n": len(entries)}


def score_groups(results_by_group: Dict[str, List[dict]], task: str) -> dict:
    """GROUP=32..64 context-bucket scoring (eval_longvqa.py GROUP splits)."""
    out = {g: score_task(task, entries)
           for g, entries in sorted(results_by_group.items())}
    out["average"] = float(np.mean([v["score"] for v in out.values()])) \
        if out else 0.0
    return out
