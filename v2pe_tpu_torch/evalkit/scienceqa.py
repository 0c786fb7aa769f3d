"""ScienceQA (image split) adapter.

Behavior parity with ``eval/scienceqa/evaluate_scienceqa.py``:

* prompt = [hint +] question + "A. ..." choice lines + the option-letter
  instruction (:54-88, :134);
* answers are stored as choice indices; the gold letter is
  ``ABCDE[answer]`` (:87);
* prediction post-processing: first-letter / option-content mapping
  (:118-130, shared with MMMU);
* score: plain accuracy over the test items (the reference prints
  per-sample correctness into a jsonl then averages).
"""

from __future__ import annotations

from typing import Dict, Sequence

from v2pe_tpu_torch.evalkit.mmmu import post_process_option_letter

PROMPT = "Answer with the option's letter from the given choices directly."
LETTERS = ["A", "B", "C", "D", "E"]


def build_question(question: str, choices: Sequence[str],
                   hint: str = None) -> tuple:
    """(prompt text, letter->choice dict) — evaluate_scienceqa.py:54-88."""
    options = {LETTERS[i]: c for i, c in enumerate(choices)}
    q = question
    if hint:
        q = hint + "\n" + q
    q += "\n" + "\n".join(f"{k}. {v}" for k, v in options.items())
    q += "\n" + PROMPT
    return q, options


def gold_letter(answer_index: int) -> str:
    return LETTERS[answer_index]


def post_process(pred: str, options: Dict[str, str]) -> str:
    return post_process_option_letter(pred, options)


def score_outputs(outputs: Sequence[dict]) -> dict:
    """outputs: {prediction (raw text), options (letter->text), answer
    (gold letter)}."""
    n, correct = 0, 0
    for o in outputs:
        pred = post_process(str(o["prediction"]), o.get("options", {}))
        n += 1
        correct += (pred == o["answer"])
    return {"acc": round(correct / n, 4) if n else 0.0, "num": n}
