"""MMBench / CCBench adapter: TSV dataset handling, prompt construction,
option-letter post-processing, submission writer, dev-split scoring.

Behavior parity with ``eval/mmbench/evaluate_mmbench.py``:

* dataset rows come from a TSV with base64 ``image``, ``question``,
  option columns A..E (NaN = absent), optional ``hint``/``answer``
  (``:91-138``);
* prompt = hint + question + "A. ..." option lines + language-specific
  instruction (``:109-124``); en prompt appended for 'en', cn for 'cn';
* prediction post-processing = first-letter / option-content mapping
  (``:167-179``, identical to MMMU post_process);
* output: per-item records keyed by ``index``; the reference writes an
  xlsx submission with a ``prediction`` column joined on index
  (``:305-321``) — we write submission rows as TSV/JSONL (xlsx needs
  openpyxl; the upload format only requires the same columns);
* the official test split is scored server-side; the dev split has
  ``answer`` so we also report plain accuracy.
"""

from __future__ import annotations

import base64
import csv
import io
import json
from typing import Dict, List, Optional, Sequence

from v2pe_tpu_torch.evalkit.mmmu import post_process_option_letter

PROMPTS = {
    "en": "Answer with the option's letter from the given choices directly.",
    "cn": "请直接回答选项字母。",
}
OPTION_CANDIDATES = ["A", "B", "C", "D", "E"]


def read_tsv(path: str) -> List[dict]:
    """Rows as dicts; empty strings -> None (pandas-NaN equivalent)."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t")
        rows = []
        for row in reader:
            rows.append({k: (v if v not in ("", None) else None)
                         for k, v in row.items()})
    return rows


def decode_image(row: dict):
    """base64 'image' column -> PIL image (:99)."""
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(row["image"]))) \
        .convert("RGB")


def extract_options(row: dict) -> Dict[str, str]:
    return {c: row[c] for c in OPTION_CANDIDATES if row.get(c) is not None}


def build_question(row: dict, language: str = "en") -> str:
    """hint + question + lettered options + instruction (:109-124)."""
    question = row["question"]
    if row.get("hint") is not None:
        question = row["hint"] + "\n" + question
    for k, v in extract_options(row).items():
        question += f"\n{k}. {v}"
    return question + "\n" + PROMPTS["cn" if language == "cn" else "en"]


def post_process(pred: str, options: Dict[str, str]) -> str:
    return post_process_option_letter(pred, options)


def write_submission(rows: Sequence[dict], outputs: Sequence[dict],
                     path: str):
    """Submission file: original TSV columns minus the heavy ones, plus a
    ``prediction`` column joined on ``index`` (:309-319). JSONL (one row per
    line) — the grader-facing fields are identical."""
    drop = {"hint", "category", "source", "image", "comment", "l2-category"}
    pred_by_index = {str(o["index"]): o["prediction"] for o in outputs}
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            rec = {k: v for k, v in row.items() if k not in drop}
            rec["prediction"] = pred_by_index.get(str(row["index"]))
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")


def score_outputs(outputs: Sequence[dict]) -> dict:
    """Dev-split accuracy: each output has prediction (raw text), options,
    answer (letter), index."""
    n, correct = 0, 0
    for o in outputs:
        if o.get("answer") is None:
            continue
        pred = post_process(str(o["prediction"]), o.get("options", {}))
        n += 1
        correct += (pred == o["answer"])
    return {"acc": round(correct / n, 4) if n else 0.0, "num": n}
