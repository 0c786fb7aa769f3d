"""Drivers for the general VLM benchmark suite (MMMU / MMBench / POPE /
ScienceQA / SEED): jsonl-item -> prompt -> chat -> output record, plus
score-file routines. The shared loop skeleton (shard / resume / merge) is
evalkit.runner; this module supplies each benchmark's item adapter, mirroring
the per-script drivers under ``eval/{mmmu,mmbench,pope,scienceqa,seed}/``.

Item schemas (one json per line):
  mmmu      {id, category, question_type, question, options[], answer,
             image | images[]}
  mmbench   rows of the reference TSV (read with evalkit.mmbench.read_tsv;
             base64 'image' column) — language picks the instruction
  pope      {question_id, category, image, text, label?}; the driver appends
             the single-word prompt (evaluate_pope.py:102)
  scienceqa {id, question, choices[], hint?, answer(int), image}
  seed      {question_id, text(pre-rendered prompt), image, answer,
             question_type_id}
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from v2pe_tpu_torch.evalkit import mmbench, mmmu, pope, scienceqa, seed

GENERAL_BENCHMARKS = ("mmmu", "mmbench", "pope", "scienceqa", "seed")

# item-id field per benchmark, for the runner's resume skip sets
ID_KEYS = {"mmmu": "id", "mmbench": "index", "pope": "question_id",
           "scienceqa": "id", "seed": "question_id"}


def _load_tiles(chat_model, images, max_tiles: int,
                upscale_first: bool = False):
    """images: path / PIL / list of either -> (pixels, num_patches_list)."""
    from v2pe_tpu_torch.data.datasets import load_image

    if images is None:
        return None, []
    if not isinstance(images, (list, tuple)):
        images = [images]
    pixel_list, npl = [], []
    for i, img in enumerate(images):
        if isinstance(img, str):
            img = load_image(img)
        # MMMU: first image gets the full tile budget plus a 2x bilinear
        # upscale before tiling (evaluate_mmmu.py:95-102); extra option
        # images get 1 tile
        budget = max_tiles if i == 0 else 1
        if upscale_first and i == 0:
            from PIL import Image

            img = img.resize((img.width * 2, img.height * 2), Image.BILINEAR)
        pv, n = chat_model.load_pixels(img, max_num=budget)
        pixel_list.append(pv)
        npl.append(n)
    return (np.concatenate(pixel_list) if pixel_list else None), npl


def build_infer_fn(benchmark: str, chat_model, *, max_tiles: int = 6,
                   language: str = "en",
                   rope_pos_id_version: Optional[str] = None,
                   rope_pos_id_stride: Optional[int] = None,
                   generation_config=None):
    """infer_fn(item) -> output record for runner.run_shard."""

    def chat(pixels, question, npl):
        q = question if pixels is None or "<image>" in question \
            else "<image>\n" + question
        return chat_model.chat(
            pixels, q, generation_config, num_patches_list=npl,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)

    if benchmark == "mmmu":
        def infer(item):
            question, options = mmmu.build_question(
                item["question"], item.get("options", []),
                item.get("question_type", "multiple-choice"))
            pixels, npl = _load_tiles(
                chat_model, item.get("images", item.get("image")), max_tiles,
                upscale_first=True)
            pred = chat(pixels, question, npl)
            return {"id": item["id"], "category": item.get("category", "all"),
                    "question_type": item.get("question_type",
                                              "multiple-choice"),
                    "options": item.get("options", []),
                    "answer": item.get("answer"), "prediction": pred}
        return infer

    if benchmark == "mmbench":
        def infer(item):
            question = mmbench.build_question(item, language)
            img = item.get("image")
            # base64 TSV column vs filesystem path: decide by whether the
            # string is a real file — base64 of a JPEG starts with "/9j/",
            # so a startswith("/") test misroutes JPEGs
            if img and len(img) > 260 and not os.path.exists(img):
                img = mmbench.decode_image(item)
            pixels, npl = _load_tiles(chat_model, img, max_tiles)
            pred = chat(pixels, question, npl)
            return {"id": str(item["index"]), "index": item["index"],
                    "options": mmbench.extract_options(item),
                    "answer": item.get("answer"), "prediction": pred}
        return infer

    if benchmark == "pope":
        def infer(item):
            question = item["text"] + " " + pope.PROMPT
            pixels, npl = _load_tiles(chat_model, item.get("image"),
                                      max_tiles)
            pred = chat(pixels, question, npl)
            return {"id": item["question_id"],
                    "question_id": item["question_id"],
                    "category": item.get("category", "all"),
                    "order": item.get("order", item["question_id"]),
                    "text": pred}
        return infer

    if benchmark == "scienceqa":
        def infer(item):
            question, options = scienceqa.build_question(
                item["question"], item["choices"], item.get("hint"))
            pixels, npl = _load_tiles(chat_model, item.get("image"),
                                      max_tiles)
            pred = chat(pixels, question, npl)
            return {"id": item.get("id", item["question"][:64]),
                    "options": options,
                    "answer": scienceqa.gold_letter(item["answer"]),
                    "prediction": pred}
        return infer

    if benchmark == "seed":
        def infer(item):
            pixels, npl = _load_tiles(chat_model, item.get("image"),
                                      max_tiles)
            pred = chat(pixels, item["text"], npl)
            return {"id": item["question_id"],
                    "question_id": item["question_id"],
                    "answer": item.get("answer"),
                    "question_type_id": item.get("question_type_id", 1),
                    "prediction": pred}
        return infer

    raise ValueError(f"unknown general benchmark: {benchmark}")


def score_file(benchmark: str, path: str,
               pope_label_files: Optional[Dict[str, str]] = None,
               seed_type_names: Optional[Dict[int, str]] = None) -> dict:
    """Score a merged output jsonl with the benchmark's scorer."""
    outputs = [json.loads(l) for l in open(path)]
    if benchmark == "mmmu":
        return mmmu.score_outputs(outputs)
    if benchmark == "mmbench":
        return mmbench.score_outputs(outputs)
    if benchmark == "pope":
        assert pope_label_files, "pope scoring needs category label files"
        return pope.score_outputs(outputs, pope_label_files)
    if benchmark == "scienceqa":
        return scienceqa.score_outputs(outputs)
    if benchmark == "seed":
        return seed.score_outputs(outputs, seed_type_names)
    raise ValueError(f"unknown general benchmark: {benchmark}")
