"""MMMU benchmark adapter: answer extraction, per-category scoring, driver.

Behavior parity with the reference MMMU evaluator (itself the public MMMU
benchmark code vendored at ``eval/mmmu/``):

* multi-choice answer extraction — ``eval/mmmu/eval_utils.py:11-63``
  (``parse_multi_choice_response``): bracketed "(A)" hits beat bare " A "
  hits beat option-content substring hits (only for >5-word responses);
  ties resolved by the LAST occurrence; no hit -> random choice;
* open-response extraction — ``eval_utils.py:127-177``: key-phrase tails
  ("answer is ...", trailing "=") + all number forms, normalized to
  rounded floats / padded single chars;
* instance scoring — ``eval_utils.py:182-224`` (exact index match for MC,
  normalized containment for open);
* per-category aggregation with instruction-level average —
  ``eval_utils.py:254-263``, ``main_eval_only.py``;
* the short-prediction option mapping shared by mmbench/scienceqa/seed —
  ``evaluate_mmmu.py:149-161`` (``post_process``);
* prompt construction — ``evaluate_mmmu.py:74-113``: choices lettered
  "A. ..." lines, hint prepended, per-type instruction appended.
"""

from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

MC_PROMPT = "Answer with the option's letter from the given choices directly."
OPEN_PROMPT = "Answer the question using a single word or phrase."
CHOICE_LETTERS = ["A", "B", "C", "D", "E", "F", "G", "H", "I", "J", "K", "L",
                  "M"]

_STRIP_CHARS = [",", ".", "!", "?", ";", ":", "'"]
_TRIVIAL = {":", ",", ".", "!", "?", ";", "'"}


def get_multi_choice_info(options: Sequence[str]
                          ) -> Tuple[Dict[str, str], List[str]]:
    """(index2ans, all_choices) for a list of option strings
    (data_utils.py:60-73)."""
    index2ans = {chr(ord("A") + i): opt for i, opt in enumerate(options)}
    return index2ans, list(index2ans.keys())


def parse_multi_choice_response(response: str, all_choices: Sequence[str],
                                index2ans: Dict[str, str],
                                rng: Optional[random.Random] = None) -> str:
    """Extract the predicted choice letter (eval_utils.py:11-63)."""
    for ch in _STRIP_CHARS:
        response = response.strip(ch)
    response = f" {response} "

    # tier 1: bracketed letters "(A)"
    candidates = [c for c in all_choices if f"({c})" in response]
    bracketed = bool(candidates)
    # tier 2: bare letters " A "
    if not candidates:
        candidates = [c for c in all_choices if f" {c} " in response]
    # tier 3: option content substring, only for long-form answers
    content_match = False
    if not candidates and len(response.split()) > 5:
        candidates = [c for c, ans in index2ans.items()
                      if ans.lower() in response.lower()]
        content_match = bool(candidates)

    if not candidates:
        return (rng or random).choice(list(all_choices))
    if len(candidates) == 1:
        return candidates[0]
    # several hits: take the one occurring LAST in the response
    if content_match:
        keys = [response.lower().rfind(index2ans[c].lower())
                for c in candidates]
    elif bracketed:
        keys = [response.rfind(f"({c})") for c in candidates]
    else:
        keys = [response.rfind(f" {c} ") for c in candidates]
    return candidates[max(range(len(candidates)), key=keys.__getitem__)]


def check_is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(s: str) -> list:
    """Numbers -> [round(float, 2)]; single chars -> space-padded variants;
    else lowercase (eval_utils.py:79-101)."""
    s = s.strip()
    if check_is_number(s):
        return [round(float(s.replace(",", "")), 2)]
    s = s.lower()
    if len(s) == 1:
        return [f" {s}", f"{s} "]
    return [s]


# the three number forms the reference extracts (eval_utils.py:104-124)
_NUM_COMMAS = r"-?\b\d{1,3}(?:,\d{3})+\b"
_NUM_SCI = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
_NUM_SIMPLE = r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])"


def extract_numbers(s: str) -> List[str]:
    return (re.findall(_NUM_COMMAS, s) + re.findall(_NUM_SCI, s)
            + re.findall(_NUM_SIMPLE, s))


_KEY_INDICATORS = ["could be ", "so ", "is ", "thus ", "therefore ",
                   "final ", "answer ", "result "]


def parse_open_response(response: str) -> list:
    """Normalized candidate answers from a free-form response
    (eval_utils.py:127-177)."""
    text = response.strip().strip(".").lower()
    subs = re.split(r"\.\s(?=[A-Z])|\n", text)
    keys: List[str] = []
    for i, sub in enumerate(subs):
        indicators = _KEY_INDICATORS + ["="] if i == len(subs) - 1 \
            else _KEY_INDICATORS
        shortest = None
        for ind in indicators:
            if ind in sub:
                tail = sub.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in _TRIVIAL:
            keys.append(shortest)
    if not keys:
        keys = [text]

    preds = list(keys)
    for k in keys:
        preds.extend(extract_numbers(k))
    out = []
    for p in preds:
        out.extend(normalize_str(p))
    return list(set(out))


def eval_multi_choice(gold, pred) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return pred in golds


def eval_open(gold, pred_list) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    norm_answers = []
    for g in golds:
        norm_answers.extend(normalize_str(g))
    for pred in pred_list:
        if isinstance(pred, str):
            if any(isinstance(a, str) and a in pred for a in norm_answers):
                return True
        elif pred in norm_answers:
            return True
    return False


def evaluate_samples(samples: Sequence[dict]) -> Tuple[Dict[str, str], dict]:
    """Batch judge: each sample has question_type / answer / parsed_pred
    (eval_utils.py:228-250)."""
    judge, correct = {}, 0
    for s in samples:
        ok = eval_multi_choice(s["answer"], s["parsed_pred"]) \
            if s["question_type"] == "multiple-choice" \
            else eval_open(s["answer"], s["parsed_pred"])
        judge[s["id"]] = "Correct" if ok else "Wrong"
        correct += ok
    if not samples:
        return judge, {"acc": 0}
    return judge, {"acc": correct / len(samples)}


def calculate_ins_level_acc(results: Dict[str, dict]) -> float:
    """Instruction-weighted average over per-category results
    (eval_utils.py:254-263)."""
    num = sum(r["acc"] * r["num_example"] for r in results.values())
    den = sum(r["num_example"] for r in results.values())
    return num / den if den else 0


def post_process_option_letter(pred: str, options: Dict[str, str]) -> str:
    """Short-prediction -> option letter mapping shared by
    mmmu/mmbench/scienceqa/seed (evaluate_mmmu.py:149-161)."""
    pred = pred.strip()
    if len(pred) == 1:
        return pred
    if pred and pred[0] in options:
        return pred[0]
    for k, v in options.items():
        if v in pred:
            return k
    return pred


def build_question(question: str, options: Sequence[str],
                   question_type: str = "multiple-choice") -> Tuple[str, dict]:
    """Prompt text + letter->option dict (evaluate_mmmu.py:74-113)."""
    q = question.strip()
    opt_map = {CHOICE_LETTERS[i]: str(c).strip()
               for i, c in enumerate(options)}
    if opt_map:
        q += "\n" + "\n".join(f"{k}. {v}" for k, v in opt_map.items())
    q += "\n" + (MC_PROMPT if question_type == "multiple-choice"
                 else OPEN_PROMPT)
    return q.strip(), opt_map


def score_outputs(outputs: Sequence[dict],
                  rng: Optional[random.Random] = None) -> dict:
    """Score a list of model outputs and aggregate per category + overall.

    Each output: {id, category, question_type, options (list), answer,
    prediction (raw model text)}. Mirrors main_eval_only.py: MC answers go
    through parse_multi_choice_response; open answers through
    parse_open_response; per-category acc plus instruction-level average.
    """
    by_cat: Dict[str, List[dict]] = {}
    for o in outputs:
        if o["question_type"] == "multiple-choice":
            index2ans, all_choices = get_multi_choice_info(
                o.get("options", []))
            parsed = parse_multi_choice_response(
                str(o["prediction"]), all_choices, index2ans, rng)
        else:
            parsed = parse_open_response(str(o["prediction"]))
        by_cat.setdefault(o.get("category", "all"), []).append(
            {"id": o["id"], "question_type": o["question_type"],
             "answer": o["answer"], "parsed_pred": parsed})

    results = {}
    for cat, samples in by_cat.items():
        _, metrics = evaluate_samples(samples)
        results[cat] = {"acc": round(metrics["acc"], 3),
                        "num_example": len(samples)}
    overall = calculate_ins_level_acc(results)
    return {"categories": results,
            "overall": {"acc": round(overall, 3),
                        "num_example": sum(r["num_example"]
                                           for r in results.values())}}
