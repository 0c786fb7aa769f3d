"""General-VQA benchmark drivers (chartqa / docvqa / ai2d / infovqa / gqa /
okvqa / textvqa / vizwiz / vqav2 / ocrvqa).

Runnable counterpart of ``eval/vqa/evaluate_vqa.py`` (703 LoC): the
per-dataset registry (``DS_COLLECTIONS``, evaluate_vqa.py:21-143), prompt
selection (:322-330), output-record schemas (:383-419), and the scoring
dispatch (:536-586 — TextVQA consensus accuracy / ANLS / relaxed accuracy /
exact match). Items come from the reference's test jsonl format:
``{image, question, question_id, answer?}``.

The EvalAI answer processor + leave-one-out consensus scorer reproduce
``eval/vqa/textvqa_eval.py`` (EvalAIAnswerProcessor :8-224,
TextVQAAccuracyEvaluator :227-256) exactly.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from v2pe_tpu_torch.evalkit.metrics import (_CONTRACTIONS, _PERIOD_STRIP, _PUNCT,
                                      levenshtein, relaxed_accuracy)

# ---------------------------------------------------------------------------
# Dataset registry (evaluate_vqa.py:21-143). File paths come from --data /
# --annotation CLI args; this table carries the behavioral knobs.
# ---------------------------------------------------------------------------

DS_COLLECTIONS: Dict[str, dict] = {
    "vqav2_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "vqav2_testdev": {"metric": None, "max_new_tokens": 10},
    "okvqa_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "textvqa_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "textvqa_val_ocr": {"metric": "vqa_score", "max_new_tokens": 10},
    "vizwiz_val": {"metric": "vqa_score", "max_new_tokens": 10},
    "vizwiz_test": {"metric": None, "max_new_tokens": 10},
    "docvqa_val": {"metric": "anls", "max_new_tokens": 100},
    "docvqa_test": {"metric": None, "max_new_tokens": 100},
    "chartqa_test_human": {"metric": "relaxed_accuracy",
                           "max_new_tokens": 100},
    "chartqa_test_augmented": {"metric": "relaxed_accuracy",
                               "max_new_tokens": 100},
    "gqa_testdev": {"metric": "accuracy", "max_new_tokens": 10},
    "gqa_testdev_llava": {"metric": "accuracy", "max_new_tokens": 10},
    "ocrvqa_val": {"metric": "accuracy", "max_new_tokens": 100},
    "ocrvqa_test": {"metric": "accuracy", "max_new_tokens": 100},
    "ai2diagram_test": {"metric": "accuracy", "max_new_tokens": 10},
    "infographicsvqa_val": {"metric": "anls", "max_new_tokens": 100},
    "infographicsvqa_test": {"metric": None, "max_new_tokens": 100},
}

# --max-num tile budget per base task (scripts/evaluate_auto.sh:38-88)
_TILE_BUDGET = {
    "chartqa": 12, "docvqa": 18, "infographicsvqa": 24, "ai2diagram": 12,
    "gqa": 6, "okvqa": 6, "textvqa": 12, "vizwiz": 6, "vqav2": 6,
    "ocrvqa": 6,
}

_BASE_PROMPT = "Answer the question using a single word or phrase."
_VIZWIZ_PROMPT = ("When the provided information is insufficient, respond "
                  "with 'Unanswerable'. ")


def dataset_prompt(ds_name: str) -> str:
    """Prompt suffix per dataset (evaluate_vqa.py:322-330)."""
    if "vizwiz" in ds_name:
        return _VIZWIZ_PROMPT + _BASE_PROMPT
    if "ai2d" in ds_name:
        return ""
    if "infographicsvqa" in ds_name:
        return _BASE_PROMPT  # infovqa_prompt == base prompt (:325)
    return _BASE_PROMPT


def tile_budget(ds_name: str) -> int:
    for base, n in _TILE_BUDGET.items():
        if ds_name.startswith(base):
            return n
    return 6


def output_record(ds_name: str, question: str, question_id, answer: str,
                  annotation) -> dict:
    """Reference output schema per dataset (evaluate_vqa.py:383-419), plus
    an 'id' key for the runner's resume skip set."""
    if ds_name in ("vqav2_val", "vqav2_testdev", "okvqa_val", "textvqa_val",
                   "vizwiz_val", "textvqa_val_ocr"):
        rec = {"question": question, "question_id": question_id,
               "answer": answer}
    elif ds_name in ("docvqa_val", "infographicsvqa_val", "gqa_testdev",
                     "ocrvqa_val", "ocrvqa_test", "gqa_testdev_llava",
                     "infographicsvqa_test"):
        rec = {"question": question, "questionId": question_id,
               "answer": answer, "annotation": annotation}
    elif ds_name == "ai2diagram_test":
        rec = {"question": question, "image": question_id, "answer": answer,
               "annotation": annotation}
    elif ds_name in ("chartqa_test_human", "chartqa_test_augmented"):
        rec = {"question": question, "answer": answer,
               "annotation": annotation}
    elif ds_name == "docvqa_test":
        rec = {"questionId": question_id, "answer": answer}
    elif ds_name == "vizwiz_test":
        rec = {"image": str(question_id).replace("data/vizwiz/test/", ""),
               "answer": answer}
    else:
        raise NotImplementedError(ds_name)
    rec["id"] = question_id
    return rec


def build_infer_fn(ds_name: str, chat_model, *,
                   max_tiles: Optional[int] = None,
                   rope_pos_id_version: Optional[str] = None,
                   rope_pos_id_stride: Optional[int] = None,
                   generation_config=None,
                   image_root: str = ""):
    """infer_fn(item) -> reference-schema output record.

    item: {image, question, question_id, answer?} (the reference test
    jsonl line, evaluate_vqa.py:243-247)."""
    if ds_name not in DS_COLLECTIONS:
        raise ValueError(f"unknown vqa dataset {ds_name!r}; known: "
                         f"{sorted(DS_COLLECTIONS)}")
    import os

    from v2pe_tpu_torch.data.datasets import load_image

    prompt = dataset_prompt(ds_name)
    budget = max_tiles if max_tiles is not None else tile_budget(ds_name)

    def infer(item):
        question = item["question"]
        if prompt:
            question = question + " " + prompt  # :265-266
        img = item["image"]
        if image_root and not os.path.isabs(img):
            img = os.path.join(image_root, img)
        pixels, n = chat_model.load_pixels(load_image(img), max_num=budget)
        q = question if "<image>" in question else "<image>\n" + question
        pred = chat_model.chat(
            pixels, q, generation_config, num_patches_list=[n],
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)
        return output_record(ds_name, item["question"], item["question_id"],
                             pred, item.get("answer"))

    return infer


# ---------------------------------------------------------------------------
# EvalAI answer processing + TextVQA consensus accuracy
# (textvqa_eval.py:8-256, exact semantics)
# ---------------------------------------------------------------------------

_EVALAI_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = ("a", "an", "the")
_COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")


def evalai_process(text: str) -> str:
    """EvalAIAnswerProcessor.__call__ (textvqa_eval.py:181-224)."""
    t = str(text).lower()
    t = t.replace(",", "").replace("?", "").replace("'s", " 's").strip()
    t = t.replace("\n", " ").replace("\t", " ").strip()
    out = t
    for p in _PUNCT:
        if (p + " " in t or " " + p in t) or \
                re.search(_COMMA_STRIP, t) is not None:
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    words = []
    for w in out.lower().split():
        w = _EVALAI_NUMBER_MAP.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    for i, w in enumerate(words):
        if w in _CONTRACTIONS:
            words[i] = _CONTRACTIONS[w]
    return " ".join(words)


def textvqa_accuracy(pred_answer: str, gt_answers: Sequence[str]) -> float:
    """Leave-one-out consensus over 10 annotator answers
    (TextVQAAccuracyEvaluator._compute_answer_scores :231-247): the score of
    a unique answer is the mean over annotators of min(1, matches-among-the-
    other-9 / 3)."""
    answers = [evalai_process(a) for a in gt_answers]
    pred = evalai_process(pred_answer)
    gt = list(enumerate(answers))
    scores = []
    for one in gt:
        others = [item for item in gt if item != one]
        matching = [item for item in others if item[1] == pred]
        scores.append(min(1.0, len(matching) / 3.0))
    return float(sum(scores) / len(scores)) if scores else 0.0


def load_vqa_annotation_answers(annotation_file: str) -> Dict:
    """question_id -> [10 annotator answers] from the official annotations
    json (evaluate_vqa.py:539-545)."""
    ann = json.load(open(annotation_file))["annotations"]
    return {item["question_id"]: [a["answer"] for a in item["answers"]]
            for item in ann}


def _docvqa_anls(pred: str, gts: Sequence[str], threshold: float = 0.5
                 ) -> float:
    """ANLS exactly as infographicsvqa_eval.py:131-148 computes it: the
    edit distance runs on whitespace-normalized lowercase strings but the
    normalizing length is max over the RAW string lengths; the per-question
    score 1 - min(dist/length) is zeroed only when strictly below the
    threshold (0.5 survives)."""
    values = []
    det_norm = " ".join(str(pred).strip().lower().split())
    for gt in gts:
        gt_norm = " ".join(str(gt).strip().lower().split())
        length = max(len(str(gt)), len(str(pred)))
        values.append(0.0 if length == 0
                      else levenshtein(gt_norm, det_norm) / float(length))
    result = 1 - min(values) if values else 0.0
    return result if result >= threshold else 0.0


def load_anls_annotation_answers(annotation_file: str) -> Dict:
    """questionId -> answers from the DocVQA/InfographicsVQA ground-truth
    json ({'data': [{questionId, answers: [...]}, ...]})."""
    gt = json.load(open(annotation_file))["data"]
    return {int(r["questionId"]): r["answers"] for r in gt}


def score_outputs(ds_name: str, outputs: List[dict],
                  annotation_file: Optional[str] = None) -> dict:
    """Score a merged output list with the dataset's reference metric
    (evaluate_vqa.py:536-586). Datasets with metric None are
    submission-only (server-scored test splits)."""
    metric = DS_COLLECTIONS[ds_name]["metric"]
    if metric is None:
        return {"dataset": ds_name, "metric": None, "n": len(outputs),
                "note": "test split: submit the results file"}
    if metric == "vqa_score":
        assert annotation_file, \
            f"{ds_name} needs the official annotations json (--annotation)"
        qid2answers = load_vqa_annotation_answers(annotation_file)
        scores = [textvqa_accuracy(o["answer"], qid2answers[o["question_id"]])
                  for o in outputs if o["question_id"] in qid2answers]
        acc = float(np.mean(scores)) if scores else 0.0
    elif metric == "anls":
        if annotation_file:  # official GT json (infographicsvqa_eval -g)
            qid2ans = load_anls_annotation_answers(annotation_file)
            scores = [_docvqa_anls(o["answer"], qid2ans[int(o["questionId"])])
                      for o in outputs if int(o["questionId"]) in qid2ans]
        else:  # fall back to the test-jsonl answers carried in the records
            scores = [_docvqa_anls(o["answer"],
                                   _as_list(o.get("annotation")))
                      for o in outputs]
        acc = float(np.mean(scores)) if scores else 0.0
    elif metric == "relaxed_accuracy":
        scores = [float(max(relaxed_accuracy(str(o["answer"]).strip(), a)
                            for a in _as_list(o["annotation"])))
                  for o in outputs]
        acc = float(np.mean(scores)) if scores else 0.0
    elif metric == "accuracy":
        scores = [float(any(
            str(o["answer"]).strip().lower() == str(a).strip().lower()
            for a in _as_list(o["annotation"]))) for o in outputs]
        acc = float(np.mean(scores)) if scores else 0.0
    else:
        raise NotImplementedError(metric)
    return {"dataset": ds_name, "metric": metric, "accuracy": acc,
            "n": len(outputs)}


def _as_list(x):
    if x is None:
        return [""]
    return x if isinstance(x, (list, tuple)) else [x]
