"""MileBench benchmark adapter + scorers.

Parity targets: ``eval/milebench/evaluate.py`` (Eval class: punctuation
normalization :124-145, option matching :188-243, multi-choice judging
:244-303, needle scoring :304-341, Rouge-L for generation tasks :156-186,
image-quantity-level buckets Few/Medium/Many :146-154) and the per-task
aggregation of ``score.py``. The Rouge-L f-measure is implemented here
directly (LCS-based) instead of the pip `rouge` dependency."""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def char_label(index: int) -> str:
    """0->A ... 25->Z, 26->AA style (evaluate.py:116-122)."""
    if index < 26:
        return chr(index + 65)
    if index < 52:
        return "A" + chr(index + 65 - 26)
    return "B" + chr(index + 65 - 52)


def _process_punct(text: str) -> str:
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or \
                re.search(_COMMA_STRIP, text) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out, re.UNICODE)


def process(answer: str) -> str:
    """evaluate.py:136-145."""
    answer = answer.replace("\n", " ").replace("\t", " ").strip()
    answer = _process_punct(answer)
    answer = answer.strip("'").strip('"').strip().lower()
    return answer


def image_quantity_level(sample: dict) -> str:
    n = len(sample["image"])
    if n < 6:
        return "Few"
    if n > 31:
        return "Many"
    return "Medium"


def rouge_l_f(pred: str, ref: str) -> float:
    """Rouge-L f-measure over whitespace tokens (replaces pip `rouge`)."""
    p, r = pred.split(), ref.split()
    if not p or not r:
        return 0.0
    dp = [[0] * (len(r) + 1) for _ in range(len(p) + 1)]
    for i in range(1, len(p) + 1):
        for j in range(1, len(r) + 1):
            if p[i - 1] == r[j - 1]:
                dp[i][j] = dp[i - 1][j - 1] + 1
            else:
                dp[i][j] = max(dp[i - 1][j], dp[i][j - 1])
    lcs = dp[-1][-1]
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(r)
    beta = 1.2
    return ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)


def match_choice(text: str, option: Dict[str, str]) -> str:
    """evaluate.py:188-243: try 'A option-text', then option text alone,
    then a leading letter; fall back to letters present in the text."""

    def prep(s: str) -> str:
        s = process(s)
        for ch in ["\\", ".", "^", "$", "*", "+", "?", "{", "}", "[", "]",
                   "|", "(", ")"]:
            if ch in s:
                s = s.replace(ch, "\\" + ch)
        return s

    if text == "":
        return "C"
    try:
        option_str = "|".join(prep(f"{k} {v}") for k, v in option.items())
        m = re.search(rf"({option_str})", text, re.S)
        if m:
            return m.group(0)[0].upper()

        option_str = "|".join(prep(v).replace(" ", "")
                              for v in option.values())
        m = re.search(rf"({option_str})", text.replace(" ", ""), re.S)
        if m:
            for k, v in option.items():
                if m[0].strip() == prep(v).replace(" ", ""):
                    return k.upper()

        m = re.match(r"^([A-D])", text.upper().strip())
        if m:
            return m.group(1)
    except Exception:
        return text
    return "".join(c.upper() for c in text if c.upper() in option)


def judge_multi_choice(gt_response: str, pred_response: str,
                       choice_list: Sequence[str]) -> Tuple[int, str]:
    gt = process(gt_response)
    pred = process(pred_response)
    choices = [process(c) for c in choice_list]
    assert gt in choices, (gt, choices)
    option = {char_label(i): c for i, c in enumerate(choices)}
    selected = match_choice(pred, option)
    gt_chr = char_label(choices.index(gt))
    return int(selected == gt_chr), selected


def _bucketize(scores_by_level: Dict[str, List[float]]) -> dict:
    return {
        "image_quantity_level-Accuracy": {
            k: float(np.mean(v)) if v else 0
            for k, v in scores_by_level.items()},
        "image_quantity_level-Result": {
            k: [sum(v), len(v)] for k, v in scores_by_level.items()},
    }


def evaluate_multichoice(predictions: List[dict]) -> dict:
    """predictions: [{sample_id, gt_response, pred_response, choice_list,
    image}]."""
    levels = {"Few": [], "Medium": [], "Many": []}
    correct = 0
    for s in predictions:
        score, sel = judge_multi_choice(s["gt_response"],
                                        s["pred_response"],
                                        s["choice_list"])
        s["extracted"], s["result"] = sel, score
        correct += score
        levels[image_quantity_level(s)].append(score)
    return {"Accuracy": correct / max(len(predictions), 1),
            **_bucketize(levels)}


def evaluate_needle(predictions: List[dict], needle: bool = True) -> dict:
    levels = {"Few": [], "Medium": [], "Many": []}
    correct = 0
    for s in predictions:
        gt = process(s["gt_response"])
        pred = process(s["pred_response"])
        score = int(gt in pred.split()) if needle else int(gt in pred)
        s["result"] = score
        correct += score
        levels[image_quantity_level(s)].append(score)
    return {"Accuracy": correct / max(len(predictions), 1),
            **_bucketize(levels)}


def evaluate_rouge(predictions: List[dict]) -> dict:
    levels = {"Few": [], "Medium": [], "Many": []}
    scores = []
    for s in predictions:
        gt = process(s["gt_response"])
        pred = process(s["pred_response"])
        score = 0.0 if pred == "" else rouge_l_f(pred, gt)
        scores.append(score)
        levels[image_quantity_level(s)].append(score)
    return {"Rouge-L f": float(np.mean(scores)) if scores else 0.0,
            **_bucketize(levels)}


def aggregate(task_scores: Dict[str, dict]) -> dict:
    """score.py-style aggregation: mean accuracy per task group."""
    accs = {}
    for task, s in task_scores.items():
        accs[task] = s.get("Accuracy", s.get("Rouge-L f", 0.0))
    return {"per_task": accs,
            "average": float(np.mean(list(accs.values()))) if accs else 0.0}
