"""MileBench inference adapter (dataset loading + prompting).

Parity with ``eval/milebench/utils.py`` (MileBenchDataset, 228 LoC) and
``eval_milebench.py``: per-sample prompt = task instruction + context with
``{image#i}``/``<ImageHere>`` markers replaced by ``<image>`` tags, images
tiled with a shared budget, grouped by image count (split_data :126-141);
the few-shot ICL variant (eval_milebench_shot.py) prepends N exemplar
QA pairs from a pool."""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


def build_prompt(sample: dict, combine_image: Optional[int] = None) -> str:
    """task_instance -> prompt with <image> markers (utils.py semantics)."""
    task_instance = sample["task_instance"]
    context = task_instance["context"]
    if combine_image:
        for i in range(combine_image):
            context = context.replace(f"{{image#{i + 1}}}", "<image>")
            context = context.replace(f"{{table#{i + 1}}}", "<image>")
    else:
        for i in range(len(task_instance.get("images_path", []))):
            context = context.replace(f"{{image#{i + 1}}}", "<image>")
            context = context.replace(f"{{table#{i + 1}}}", "<image>")
    prompt = sample.get("task_instruction", "") + "\n" + context
    if "choice_list" in task_instance:
        choices = task_instance["choice_list"]
        choice_str = "\nChoice list: \n"
        choice_str += "\n".join(
            f"{chr(65 + i)}. {c}" for i, c in enumerate(choices))
        choice_str += "\nYour answer is: "
        prompt += choice_str
    return prompt


def split_data_by_image_count(samples: List[dict]) -> Dict[int, List[dict]]:
    """Group samples by number of images (eval_milebench.py:126-141) so
    same-shape batches compile once."""
    groups = defaultdict(list)
    for s in samples:
        n = len(s["task_instance"].get("images_path", []))
        groups[n].append(s)
    return dict(groups)


def build_infer_fn(chat_model, data_root: str, max_tiles_total: int = 24,
                   generation_config=None,
                   rope_pos_id_version: Optional[str] = None,
                   rope_pos_id_stride: Optional[int] = None,
                   few_shot_examples: Optional[List[dict]] = None):
    """infer_fn over MileBench core.json 'data' entries."""
    import numpy as np

    from v2pe_tpu_torch.data.datasets import load_image

    def infer(sample: dict) -> dict:
        images = sample["task_instance"].get("images_path", [])
        per_image = max(1, max_tiles_total // max(len(images), 1))
        pixel_list, num_patches_list = [], []
        for rel in images:
            img = load_image(os.path.join(data_root, rel))
            pv, n = chat_model.load_pixels(img, max_num=per_image)
            pixel_list.append(pv)
            num_patches_list.append(n)
        pixels = np.concatenate(pixel_list) if pixel_list else None

        prompt = build_prompt(sample)
        if few_shot_examples:
            shots = "\n\n".join(
                f"{build_prompt(e)}\n{e['response']}"
                for e in few_shot_examples)
            prompt = shots + "\n\n" + prompt

        response = chat_model.chat(
            pixels, prompt, generation_config,
            num_patches_list=num_patches_list,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)
        return {
            "id": sample["sample_id"],
            "sample_id": sample["sample_id"],
            "gt_response": sample["response"],
            "pred_response": response,
            "image": images,
        }

    return infer
