"""General VQA benchmark suite scorers.

Parity with the dispatch of ``eval/vqa/evaluate_vqa.py`` (1309 LoC) +
``scripts/evaluate.sh`` task routing: per-task metric selection (relaxed
accuracy for chartqa, ANLS for docvqa/infovqa, consensus VQA accuracy for
gqa/okvqa/textvqa/vizwiz/vqav2, multiple-choice accuracy for
ai2d/scienceqa/pope/mmbench/seed/mmmu) and per-task tile budgets
(``scripts/evaluate_auto.sh:38-88``)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from v2pe_tpu_torch.evalkit.longvqa import vqa_consensus_accuracy
from v2pe_tpu_torch.evalkit.metrics import anls, exact_match_mc, relaxed_accuracy

# --max-num tile budgets per task (evaluate_auto.sh:38-88)
TASK_MAX_NUM = {
    "chartqa": 12, "docvqa": 18, "infovqa": 24, "ai2d": 12, "gqa": 6,
    "okvqa": 6, "textvqa": 12, "vizwiz": 6, "vqav2": 6, "scienceqa": 6,
    "pope": 6, "mmbench": 6, "seed": 6, "mmmu": 6,
}

TASK_METRIC = {
    "chartqa": "relaxed",
    "docvqa": "anls",
    "infovqa": "anls",
    "gqa": "consensus",
    "okvqa": "consensus",
    "textvqa": "consensus",
    "vizwiz": "consensus",
    "vqav2": "consensus",
    "ai2d": "mc",
    "scienceqa": "mc",
    "pope": "yesno",
    "mmbench": "mc",
    "seed": "mc",
    "mmmu": "mc",
}


def score_item(task: str, prediction: str, annotation, options=()) -> float:
    metric = TASK_METRIC.get(task, "consensus")
    anns = annotation if isinstance(annotation, (list, tuple)) \
        else [annotation]
    anns = [str(a) for a in anns]
    if metric == "relaxed":
        return float(max(relaxed_accuracy(str(prediction).strip(), a)
                         for a in anns))
    if metric == "anls":
        return anls(prediction, anns)
    if metric == "consensus":
        if len(anns) >= 3:
            return vqa_consensus_accuracy(prediction, anns)
        p = " ".join(str(prediction).strip().lower().split())
        return float(any(p == " ".join(a.strip().lower().split())
                         for a in anns))
    if metric == "mc":
        return float(exact_match_mc(prediction, anns[0], options))
    if metric == "yesno":
        p = str(prediction).strip().lower()
        p = "yes" if p.startswith("yes") else ("no" if p.startswith("no")
                                               else p)
        return float(p == anns[0].strip().lower())
    raise NotImplementedError(metric)


def score_task(task: str, entries: List[dict]) -> dict:
    """entries: [{'prediction', 'annotation', ['options']}]."""
    scores = [score_item(task, e["prediction"], e["annotation"],
                         e.get("options", ())) for e in entries]
    return {"task": task, "metric": TASK_METRIC.get(task, "consensus"),
            "accuracy": float(np.mean(scores)) if scores else 0.0,
            "n": len(entries)}


def score_suite(results: Dict[str, List[dict]]) -> dict:
    per_task = {t: score_task(t, e) for t, e in results.items()}
    return {"per_task": per_task,
            "average": float(np.mean(
                [v["accuracy"] for v in per_task.values()]))
            if per_task else 0.0}
