"""MM-NIAH (multimodal needle-in-a-haystack) benchmark adapter + scorer.

Parity targets:
* inference loop — ``eval/mm_niah/eval_mm_niah.py`` (per-sample
  model.chat with tiled context images, V2PE pos-id kwargs);
* scoring — ``eval/mm_niah/calculate_scores.py``: bucket accuracy over
  context-length bins [1k..64k] x placed-depth 0.2 bins, weighted accuracy
  arrays, per-task mean over depth, optional heatmap rendering.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from v2pe_tpu_torch.evalkit.metrics import mmniah_is_correct

X_BINS = [1000, 2000, 4000, 8000, 12000, 16000, 24000, 32000, 40000, 48000,
          64000]
Y_INTERVAL = 0.2
CONTEXT_RANGES = [f"{i // 1000}k" for i in X_BINS]


def score_jsonl(path: str, task_name: str = "") -> Dict:
    """Score one results jsonl (entries need context_length, placed_depth,
    response, answer). Returns dict with per-bin accuracies."""
    total = np.zeros((len(X_BINS) + 1, int(1 / Y_INTERVAL)))
    correct = np.zeros_like(total)

    with open(path) as f:
        for line in f:
            entry = json.loads(line)
            x = entry["context_length"]
            y = entry["placed_depth"]
            # merged worker outputs may carry these as strings
            # (eval_logs/mmniah committed jsonls do)
            if isinstance(x, str):
                x = float(x)
            if isinstance(y, str):
                y = json.loads(y)
            if isinstance(y, list):
                y = sum(y) / len(y)
            if y == 1.0:
                y = 0.99
            answer = entry["answer"]
            if "counting" in (task_name or path) and \
                    not isinstance(answer, list):
                answer = json.loads(answer)
            xi = int(np.digitize(x, X_BINS))
            yi = int(y / Y_INTERVAL)
            total[xi][yi] += 1
            correct[xi][yi] += mmniah_is_correct(answer, entry["response"])

    sample_number = total.sum(1)[1:]
    correct_number = correct.sum(1)[1:]
    weighted_acc = np.divide(correct_number, sample_number,
                             out=np.zeros_like(correct_number),
                             where=sample_number != 0)
    weighted_avg_acc = correct.sum() / max(total.sum(), 1)
    grid = np.divide(correct, total, out=np.zeros_like(correct),
                     where=total != 0)
    depth_x_len = grid[1:].T  # (depth_bins, len_bins)
    scores = [round(v, 6) for v in depth_x_len.mean(axis=0).tolist()]
    return {
        "scores_by_length": scores,
        "weighted_acc": weighted_acc.tolist(),
        "sample_number_array": sample_number.tolist(),
        "weighted_avg_acc": float(weighted_avg_acc),
        "context_ranges": CONTEXT_RANGES,
        "grid": depth_x_len.tolist(),
    }


def score_directory(outputs_dir: str, save_dir: Optional[str] = None,
                    render_heatmaps: bool = False) -> Dict:
    """Score every <model>_<task>.jsonl in a directory; 6-task overall mean
    like calculate_scores.save (:93-121)."""
    res: Dict[str, Dict[str, dict]] = defaultdict(dict)
    for name in sorted(os.listdir(outputs_dir)):
        p = os.path.join(outputs_dir, name)
        if os.path.isdir(p) or not name.endswith(".jsonl"):
            continue
        model_name, task_name = name[:-len(".jsonl")].rsplit("_", 1)
        s = score_jsonl(p, task_name)
        res[model_name][task_name] = s
        if render_heatmaps and save_dir:
            _render_heatmap(np.asarray(s["grid"]),
                            os.path.join(save_dir, model_name,
                                         f"heatmaps_png/{task_name}.png"))

    summary = {}
    for model_name, tasks in res.items():
        all_scores = np.array([t["scores_by_length"]
                               for t in tasks.values()])
        entry = {k: v["scores_by_length"] for k, v in tasks.items()}
        if len(tasks) == 6:
            entry["overall"] = [round(v, 6)
                                for v in all_scores.mean(axis=0).tolist()]
        entry["weighted_avg_acc"] = float(
            np.mean([t["weighted_avg_acc"] for t in tasks.values()]))
        entry["context_ranges"] = CONTEXT_RANGES
        summary[model_name] = entry
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "scores.json"), "w") as f:
            json.dump(summary, f, indent=4)
    return summary


def _render_heatmap(grid: np.ndarray, path: str):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import LinearSegmentedColormap
    except Exception:
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cm = LinearSegmentedColormap.from_list(
        "niah", ["#DC143C", "#FFD700", "#3CB371"], N=100)
    plt.figure(figsize=(10, 10))
    plt.imshow(grid, vmin=0, vmax=1, cmap=cm, aspect="auto")
    plt.xticks(ticks=np.arange(len(X_BINS)), labels=CONTEXT_RANGES,
               rotation=45)
    plt.yticks(ticks=np.arange(grid.shape[0]),
               labels=[f"{(j + 1) * Y_INTERVAL:.1f}"
                       for j in range(grid.shape[0])])
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()


def build_infer_fn(chat_model, max_tiles: int = 12,
                   rope_pos_id_version: Optional[str] = None,
                   rope_pos_id_stride: Optional[int] = None,
                   generation_config=None, data_root: Optional[str] = None):
    """infer_fn for runner.run_shard over MM-NIAH jsonl items
    ({id, context, images_list, question, answer, meta...}).

    ``images_list`` paths are relative to the benchmark distribution dir
    (the reference joins them with args.image_folder,
    eval/mm_niah/eval_mm_niah.py); ``data_root`` is that dir. Absolute and
    object-store paths pass through unchanged."""
    import numpy as np

    from v2pe_tpu_torch.data import object_store
    from v2pe_tpu_torch.data.datasets import load_image

    def infer(item: dict) -> dict:
        images = item.get("images_list") or []
        pixel_list, num_patches_list = [], []
        for path in images:
            if data_root and not os.path.isabs(path) \
                    and not object_store.is_remote(path):
                path = os.path.join(data_root, path)
            img = load_image(path)
            pv, n = chat_model.load_pixels(img, max_num=max_tiles)
            pixel_list.append(pv)
            num_patches_list.append(n)
        pixels = np.concatenate(pixel_list) if pixel_list else None
        question = item["context"] + item["question"] \
            if "context" in item else item["question"]
        response = chat_model.chat(
            pixels, question, generation_config,
            num_patches_list=num_patches_list,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)
        return {
            "id": item["id"],
            "question": item["question"],
            "answer": item["answer"],
            "response": response,
            "context_length": item.get("meta", {}).get(
                "context_length", item.get("context_length", 0)),
            "placed_depth": item.get("meta", {}).get(
                "placed_depth", item.get("placed_depth", 0.0)),
        }

    return infer
