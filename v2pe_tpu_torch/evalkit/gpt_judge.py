"""GPT-judge scoring for open-ended video QA (activitynet/msrvtt/msvd/tgif).

Parity with ``eval/eval/benchmark_generation_performance.py`` (a fork of
Video-ChatGPT's evaluate_activitynet_qa.py): the exact judge system/user
prompts (:29-49), per-sample json result files named by a per-video counter
(``<video_id>_<n>.json``, :92-107), resume by listing completed files
(:133-141), ``ast.literal_eval`` parsing of the judge's
``{'pred': 'yes'/'no', 'score': int}`` response (:53-57), and a final
combined json (:167-180).

The judge client is pluggable (``judge_client(messages) -> str``): an OpenAI
client, a local model, or a test fake — this environment has no egress, so
the harness never hard-codes a vendor call. ``summarize`` adds the
Video-ChatGPT accuracy (yes-ratio) and mean score over the combined results.
"""

from __future__ import annotations

import ast
import json
import os
from typing import Callable, Dict, List, Optional

JUDGE_SYSTEM_PROMPT = (
    "You are an intelligent chatbot designed for evaluating the correctness "
    "of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully. Here's how you can "
    "accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer."
)


def build_judge_messages(question: str, answer: str, pred: str) -> List[dict]:
    """The exact two-message chat payload
    (benchmark_generation_performance.py:27-49)."""
    user = (
        "Please evaluate the following video-based question-answer pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {answer}\n"
        f"Predicted Answer: {pred}\n\n"
        "Provide your evaluation only as a yes/no and score where the score "
        "is an integer value between 0 and 5, with 5 indicating the highest "
        "meaningful match. "
        "Please generate the response in the form of a Python dictionary "
        "string with keys 'pred' and 'score', where value of 'pred' is  a "
        "string of 'yes' or 'no' and value of 'score' is in INTEGER, not "
        "STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only provide "
        "the Python dictionary string. "
        "For example, your response should look like this: "
        "{'pred': 'yes', 'score': 4.8}."
    )
    return [{"role": "system", "content": JUDGE_SYSTEM_PROMPT},
            {"role": "user", "content": user}]


def parse_judge_response(response_message: str) -> dict:
    """ast.literal_eval + key validation (:53-57)."""
    response_dict = ast.literal_eval(response_message)
    if "pred" not in response_dict or "score" not in response_dict:
        raise ValueError(
            "Invalid response format. Please provide a response in the form "
            "of a Python dictionary string with keys 'pred' and 'score'.")
    return response_dict


def build_prediction_set(pred_contents: List[dict]):
    """video_id -> unique key numbering + qa sets (:92-127): the n-th record
    of a video becomes key ``<video_id>_<n>``."""
    video_id_counts: Dict[str, int] = {}
    prediction_set = {}
    order = []
    for sample in pred_contents:
        video_id = sample["video_id"]
        if video_id in video_id_counts:
            video_id_counts[video_id] += 1
        else:
            video_id_counts[video_id] = 0
        key = f"{video_id}_{video_id_counts[video_id]}"
        prediction_set[key] = {"q": sample["question_raw"],
                               "a": sample["answer"],
                               "pred": sample["outputs"]}
        order.append(key)
    return prediction_set, order


def annotate(prediction_set: Dict[str, dict], keys: List[str],
             output_dir: str,
             judge_client: Callable[[List[dict]], str]) -> int:
    """Judge each qa set, writing ``<key>.json`` result files
    ([response_dict, qa_set], :58-63). Returns the number judged; failures
    are skipped (the retry loop in :132-164 picks them up)."""
    n = 0
    for key in keys:
        qa_set = prediction_set[key]
        try:
            msg = build_judge_messages(qa_set["q"], qa_set["a"],
                                       qa_set["pred"])
            response_dict = parse_judge_response(judge_client(msg))
            with open(os.path.join(output_dir, f"{key}.json"), "w") as f:
                json.dump([response_dict, qa_set], f)
            n += 1
        except Exception as e:  # noqa: BLE001 — parity with :64-66
            print(f"Error processing file '{key}': {e}")
    return n


def run_generation_benchmark(
    pred_contents: List[dict],
    output_dir: str,
    output_json: str,
    judge_client: Callable[[List[dict]], str],
    max_retries: int = 5,
) -> dict:
    """The main flow (:71-180): build the prediction set, judge incomplete
    files (resume by listdir), retry until done or max_retries, combine all
    per-sample jsons into ``output_json``, and return the combined dict."""
    os.makedirs(output_dir, exist_ok=True)
    prediction_set, order = build_prediction_set(pred_contents)
    caption_files = [f"{k}.json" for k in order]

    retry = 0
    while retry < max_retries:
        completed = set(os.listdir(output_dir))
        incomplete = [f for f in caption_files if f not in completed]
        if not incomplete:
            break
        done = annotate(prediction_set, [f[:-5] for f in incomplete],
                        output_dir, judge_client)
        if done == 0:
            retry += 1

    combined = {}
    for file_name in os.listdir(output_dir):
        if file_name.endswith(".json"):
            with open(os.path.join(output_dir, file_name)) as f:
                combined[file_name[:-5]] = json.load(f)
    with open(output_json, "w") as f:
        json.dump(combined, f)
    return combined


def summarize(combined: dict) -> dict:
    """Video-ChatGPT's reported numbers over the combined judgments:
    accuracy = yes-ratio, plus the mean 0-5 score."""
    yes, scores = 0, []
    for result in combined.values():
        judgment = result[0]
        scores.append(float(judgment["score"]))
        if str(judgment["pred"]).lower() == "yes":
            yes += 1
    n = len(combined)
    return {"n": n,
            "accuracy": yes / n if n else 0.0,
            "avg_score": sum(scores) / n if n else 0.0}
