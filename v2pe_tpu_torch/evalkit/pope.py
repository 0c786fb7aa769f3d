"""POPE (object-hallucination probing) adapter.

Behavior parity with ``eval/pope/eval_pope.py:6-63`` + the driver
``eval/pope/evaluate_pope.py``:

* answer canonicalization: keep the first sentence, drop commas, answer is
  'no' iff the word set contains 'No'/'not'/'no', else 'yes' (:9-21);
* metrics per category (random/popular/adversarial label files): TP/FP/TN/FN
  with yes=positive, precision, recall, F1, accuracy, yes-ratio (:35-63);
* the driver appends the single-word prompt to each question (:102,
  evaluate_pope.py) and groups answers by question category (:79-82).
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

PROMPT = "Answer the question using a single word or phrase."


def canonical_answer(text: str) -> str:
    """First sentence, comma-stripped; 'no' iff No/not/no appears as a word
    (eval_pope.py:9-21)."""
    if text.find(".") != -1:
        text = text.split(".")[0]
    words = text.replace(",", "").split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) \
        else "yes"


def score_category(answers: Sequence[str], labels: Sequence[str]) -> dict:
    """F1 breakdown for one category (eval_pope.py:23-63): answers are raw
    model texts, labels 'yes'/'no' ground truth."""
    preds = [1 if canonical_answer(a) == "yes" else 0 for a in answers]
    golds = [0 if l == "no" else 1 for l in labels]
    tp = sum(p == 1 and g == 1 for p, g in zip(preds, golds))
    fp = sum(p == 1 and g == 0 for p, g in zip(preds, golds))
    tn = sum(p == 0 and g == 0 for p, g in zip(preds, golds))
    fn = sum(p == 0 and g == 1 for p, g in zip(preds, golds))
    precision = tp / (tp + fp) if (tp + fp) else 0.0
    recall = tp / (tp + fn) if (tp + fn) else 0.0
    f1 = 2 * precision * recall / (precision + recall) \
        if (precision + recall) else 0.0
    return {
        "TP": tp, "FP": fp, "TN": tn, "FN": fn,
        "accuracy": (tp + tn) / max(tp + tn + fp + fn, 1),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "yes_ratio": sum(preds) / max(len(preds), 1),
    }


def score_outputs(outputs: Sequence[dict],
                  label_files: Dict[str, str]) -> dict:
    """Group outputs by category and score each against its label file.

    outputs: {question_id, category, text}; label_files: category ->
    path of a jsonl with one {'label': 'yes'|'no'} per question, in question
    order (the reference zips answers with label-file order, eval_pope.py:7).
    Returns per-category metrics + the mean F1 (the README's single POPE
    number is the category average)."""
    by_cat: Dict[str, List[dict]] = {}
    for o in outputs:
        by_cat.setdefault(o["category"], []).append(o)
    results = {}
    for cat, items in by_cat.items():
        labels = [json.loads(l)["label"] for l in open(label_files[cat])]
        items = sorted(items, key=lambda x: x["order"]) \
            if items and "order" in items[0] else items
        results[cat] = score_category([i["text"] for i in items], labels)
    if results:
        results["mean_f1"] = sum(r["f1"] for r in results.values()) \
            / len(results)
    return results
