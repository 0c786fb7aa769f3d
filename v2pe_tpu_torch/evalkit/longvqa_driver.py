"""Long-VQA (32k-64k bucketed document/chart QA) runnable driver.

Counterpart of ``eval/longvqa/eval_longvqa.py`` (184 LoC): items are the
reference's annotation jsonl lines ``{id, conversations: [{value: question},
{value: answer}], image: [paths], metadata: {context_length}}``; every image
is tiled at max_num=12 (:81); per-task ``max_new_tokens`` comes from
``task2token`` (:151-169); output records are ``{id, an, pr, le}`` (:123-128).

Scoring reproduces ``eval/longvqa/calculate_scores.py``: predictions AND
annotations pass through :func:`rectify` (rectify.py:109-130) before the
task metric (v2pe_tpu_torch.evalkit.longvqa.decide_metric / score_entry).

Divergence note: the reference's ``remove_ing``/``plural2singular`` rectify
stages depend on the nltk words corpus + WordNet. When nltk data is present
they run with identical semantics; in corpus-less environments (this image)
they degrade — plural2singular to rule-based English noun rules, remove_ing
to identity — applied to BOTH sides, which keeps exact-match comparisons
consistent.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from v2pe_tpu_torch.evalkit import longvqa

# per-task max_new_tokens (eval_longvqa.py:151-169)
TASK2TOKEN = {
    "chartqa": 32, "clevr": 8, "deepform": 32, "docvqa": 32, "dvqa": 8,
    "gqa": 8, "infovqa": 32, "kleistercharity": 32, "ocrvqa": 128,
    "okvqa": 16, "svqa": 8, "tabfact": 8, "textcaps": 64, "textvqa": 64,
    "visualmrc": 256, "vizwiz": 32, "wikitablequestions": 128,
}

LONGVQA_MAX_TILES = 12  # eval_longvqa.py:81


# ---------------------------------------------------------------------------
# rectify (eval/longvqa/rectify.py)
# ---------------------------------------------------------------------------

_WORD_TO_NUMBER = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10,
    "eleven": 11, "twelve": 12, "thirteen": 13, "fourteen": 14,
    "fifteen": 15, "sixteen": 16, "seventeen": 17, "eighteen": 18,
    "nineteen": 19, "twenty": 20,
}

try:  # bit-parity path when nltk corpora are installed
    from nltk.corpus import words as _nltk_words
    from nltk.stem import WordNetLemmatizer as _WNL

    _WORD_LIST = set(_nltk_words.words())
    _LEMMATIZER = _WNL()
    _LEMMATIZER.lemmatize("cats", "n")  # force-load wordnet now
except Exception:  # corpus unavailable: documented fallbacks
    _WORD_LIST = None
    _LEMMATIZER = None


def convert_word_to_number(s: str) -> str:
    parts = s.split(" ")
    for i, ss in enumerate(parts):
        if ss.lower() in _WORD_TO_NUMBER:
            parts[i] = str(_WORD_TO_NUMBER[ss.lower()])
    return " ".join(parts)


def remove_unit(s: str) -> str:
    m = re.match(r"^([0-9]+\.?[0-9]*)\s+[A-Za-z\s]+$", s, re.DOTALL)
    return m.group(1) if m else s


def remove_commas_in_numbers(s: str) -> str:
    return re.sub(r"(?<=\d),(?=\d)", "", s)


def decide_choice(s: str) -> str:
    if len(s) > 0 and s[0] in ("A", "B", "C", "D"):
        return s[0]
    return s


def remove_percent(s: str) -> str:
    return s[:-1] if s.endswith("%") else s


def remove_bracket(s: str) -> str:
    return s.strip("[").strip("]").strip("(").strip(")").strip("{").strip("}")


def decide_yes_or_no(s: str) -> str:
    if s.startswith("Yes") or s.startswith("yes"):
        return "Yes"
    if s.startswith("No") or s.startswith("no"):
        return "No"
    return s


def remove_ing(s: str) -> str:
    if _WORD_LIST is None:
        return s
    out = s.split(" ")
    for i, w in enumerate(out):
        if w.endswith("ing"):
            root = w[:-3].lower()
            if len(root) <= 1:
                continue
            if root in _WORD_LIST:
                out[i] = root
            elif len(root) > 1 and root[-1] == root[-2] and \
                    root[:-1] in _WORD_LIST:
                out[i] = root[:-1]
            elif root + "e" in _WORD_LIST:
                out[i] = root + "e"
    return " ".join(out)


# common non-plural s-final words the rule-based fallback must not strip
_NOT_PLURALS = frozenset({
    "yes", "was", "is", "has", "does", "its", "this", "his", "gas",
    "bus", "plus", "news", "less", "lens", "as", "us",
})


def plural2singular(s: str) -> str:
    out = s.split(" ")
    for i, w in enumerate(out):
        wl = w.lower()
        if _LEMMATIZER is not None:
            out[i] = _LEMMATIZER.lemmatize(wl, "n")
        else:  # rule-based English noun singularization
            if wl in _NOT_PLURALS:
                out[i] = wl
            elif wl.endswith("ies") and len(wl) > 3:
                out[i] = wl[:-3] + "y"
            elif re.search(r"(ses|xes|zes|ches|shes)$", wl):
                out[i] = wl[:-2]
            elif wl.endswith("s") and not wl.endswith("ss") \
                    and not wl.endswith("us") and not wl.endswith("is") \
                    and len(wl) > 2:
                out[i] = wl[:-1]
            else:
                out[i] = wl
    return " ".join(out)


def fraction2float(s: str) -> str:
    for div in (":", "/"):
        if div not in s:
            continue
        nums = s.split(div)
        if len(nums) != 2:
            continue
        try:
            return str(float(nums[0]) / float(nums[1]))
        except (ValueError, ZeroDivisionError):
            continue
    return s


def rectify(task: str, an: str) -> str:
    """rectify.py:109-130 — per-task normalization chain applied to both
    predictions and annotations before scoring."""
    an = str(an).strip().strip(".")
    funcs = []
    if task in ("svqa",):
        funcs = [decide_choice]
    elif task in ("tabfact",):
        funcs = [decide_yes_or_no]
    elif task in ("chartqa", "clevr", "deepform", "okvqa", "dvqa", "gqa",
                  "infovqa", "ocrvqa", "visualmrc", "vizwiz",
                  "wikitablequestions"):
        funcs = [decide_yes_or_no, convert_word_to_number,
                 remove_commas_in_numbers, remove_unit, remove_percent,
                 remove_bracket, remove_ing, plural2singular, fraction2float]
    for f in funcs:
        an = f(an)
    return an.strip()


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def build_infer_fn(task: str, chat_model, *,
                   image_root: str = "",
                   max_tiles: int = LONGVQA_MAX_TILES,
                   rope_pos_id_version: Optional[str] = None,
                   rope_pos_id_stride: Optional[int] = None,
                   generation_config=None):
    """infer_fn(item) -> {id, an, pr, le} (eval_longvqa.py:64-128)."""
    import os

    import numpy as _np

    from v2pe_tpu_torch.data.datasets import load_image

    def infer(item):
        qs = item["conversations"][0]["value"]
        answer = item["conversations"][1]["value"]
        images = item.get("image") or []
        if not isinstance(images, (list, tuple)):
            images = [images]
        ctx_len = item.get("metadata", {}).get("context_length", -1)

        pixel_list, npl = [], []
        for img in images:
            path = img if not image_root or os.path.isabs(img) \
                else os.path.join(image_root, img)
            pv, n = chat_model.load_pixels(load_image(path),
                                           max_num=max_tiles)
            pixel_list.append(pv)
            npl.append(n)
        pixels = _np.concatenate(pixel_list) if pixel_list else None

        pred = chat_model.chat(
            pixels, qs, generation_config, num_patches_list=npl,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)
        return {"id": item["id"], "an": answer, "pr": pred, "le": ctx_len}

    return infer


def score_results(task: str, results: List[dict]) -> dict:
    """calculate_scores.py main: rectify both sides, then the task metric;
    plus per-context-length buckets (the GROUP=32/64 split the reference
    runs as separate files)."""
    metric = longvqa.decide_metric(task)
    entries = [{"answer": rectify(task, r["pr"]),
                "annotation": rectify(task, r["an"]),
                "le": r.get("le", -1)} for r in results]
    scores = [longvqa.score_entry(metric, e["answer"], e["annotation"])
              for e in entries]
    out = {"task": task, "metric": metric,
           "score": float(np.mean(scores)) if scores else 0.0,
           "n": len(entries)}
    buckets: Dict[str, List[float]] = {}
    for e, s in zip(entries, scores):
        le = e["le"]
        key = "unknown" if le is None or le < 0 else f"{round(le / 1024)}k"
        buckets.setdefault(key, []).append(s)
    out["by_context"] = {k: {"score": float(np.mean(v)), "n": len(v)}
                         for k, v in sorted(buckets.items())}
    return out
