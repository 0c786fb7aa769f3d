"""SEED-Bench (image) adapter.

Behavior parity with ``eval/seed/evaluate_seed.py`` +
``eval/seed/calculation.py``:

* items come from a jsonl with pre-rendered ``text`` prompts and letter
  answers (evaluate_seed.py:51-71);
* predictions post-processed with the shared option-letter mapping
  (:99-111); scoring then compares ``pred[0]`` if longer than one char
  (calculation.py:67-68);
* accuracy reported per question_type_id bucket, plus image
  (type ids 1-9) / video (10-12) / total rollups (calculation.py:59-97).
"""

from __future__ import annotations

from typing import Dict, Sequence

from v2pe_tpu_torch.evalkit.mmmu import post_process_option_letter

# SEED-Bench.json question_type mapping (id -> name), image tasks 1..9,
# video tasks 10..12
IMAGE_TYPE_IDS = set(range(1, 10))
VIDEO_TYPE_IDS = set(range(10, 13))


def post_process(pred: str, options: Dict[str, str]) -> str:
    return post_process_option_letter(pred, options)


def score_outputs(outputs: Sequence[dict],
                  type_names: Dict[int, str] = None) -> dict:
    """outputs: {prediction (post-processed or raw), answer (letter),
    question_type_id}. Returns per-type + image/video/total accuracy
    (percent, 2 decimals like calculation.py prints)."""
    buckets: Dict[int, list] = {}
    for o in outputs:
        pred = str(o["prediction"])
        if len(pred) != 1:
            pred = pred[0] if pred else ""
        buckets.setdefault(int(o["question_type_id"]), []).append(
            int(pred == o["answer"]))

    per_type = {}
    img_n = img_c = vid_n = vid_c = 0
    for tid, results in sorted(buckets.items()):
        name = (type_names or {}).get(tid, str(tid))
        per_type[name] = round(100 * sum(results) / len(results), 2)
        if tid in IMAGE_TYPE_IDS:
            img_n += len(results)
            img_c += sum(results)
        else:
            vid_n += len(results)
            vid_c += sum(results)
    out = {"per_type": per_type}
    total_n, total_c = img_n + vid_n, img_c + vid_c
    out["total"] = round(100 * total_c / total_n, 2) if total_n else 0.0
    if img_n:
        out["image"] = round(100 * img_c / img_n, 2)
    if vid_n:
        out["video"] = round(100 * vid_c / vid_n, 2)
    return out
