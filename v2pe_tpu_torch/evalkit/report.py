"""Eval report tooling.

Two small utilities matching the reference's standalone report scripts:

* :func:`milebench_table` — per-category MileBench averages
  (``eval/milebench/print_table_result.py``: the T/S/N/I task taxonomy,
  Accuracy with Rouge-L-f fallback, x100 one-decimal, plain table across
  models);
* :func:`mm_niah_item_markdown` — render one MM-NIAH sample to markdown
  with base64-inlined images, highlighted text needles and lettered
  choices (``eval/mm_niah/visualization.py:50-115`` — the rendering core;
  the gradio browser shell around it is replaced by a file/stdout CLI,
  which is the TPU-pod-friendly form of the tool).

CLI::

    python -m v2pe_tpu_torch.evalkit.report milebench RESULT.json [RESULT2.json ..]
    python -m v2pe_tpu_torch.evalkit.report mm-niah-item ANN.jsonl INDEX \
        --image-dir DIR [-o OUT.md]
"""

from __future__ import annotations

import base64
import io
import json
import os
from typing import Dict, List, Sequence

IMAGE_PLACEHOLDER = "<image>"

# eval/milebench/print_table_result.py:13-48 — verbatim taxonomy
TASK_CATEGORIES = {
    "T-1": ["ActionLocalization", "ActionPrediction", "ActionSequence"],
    "T-2": ["ObjectExistence", "ObjectInteraction", "MovingAttribute",
            "ObjectShuffle"],
    "T-3": ["EgocentricNavigation", "MovingDirection"],
    "T-4": ["CounterfactualInference", "StateChange", "CharacterOrder",
            "SceneTransition"],
    "S-1": ["WebQA", "TQA", "MultiModalQA", "WikiVQA"],
    "S-2": ["SlideVQA", "OCR-VQA", "DocVQA"],
    "S-3": ["Spot-the-Diff", "CLEVR-Change", "IEdit"],
    "S-4": ["MMCoQA", "ALFRED"],
    "S-5": ["nuscenes"],
    "N-1": ["TextNeedleInAHaystack"],
    "N-2": ["ImageNeedleInAHaystack"],
    "I-1": ["GPR1200"],
}


def milebench_category_averages(data: dict) -> Dict[str, float]:
    """Category -> average score x100. ``data`` is a milebench_result.json
    ({group: {task: {"Accuracy": .. | "Rouge-L f": ..}}}); tasks score by
    Accuracy, generation tasks by Rouge-L f (print_table_result.py:52-67)."""
    out = {}
    for category, tasks in TASK_CATEGORIES.items():
        scores = []
        for task in tasks:
            for sub_data in data.values():
                if task in sub_data:
                    acc = sub_data[task].get("Accuracy")
                    rouge = sub_data[task].get("Rouge-L f")
                    if acc is not None:
                        scores.append(acc)
                    elif rouge is not None:
                        scores.append(rouge)
        out[category] = (sum(scores) / len(scores) if scores else 0) * 100
    return out


def milebench_table(results: Dict[str, dict]) -> str:
    """Plain table (model columns sorted case-insensitively, one decimal —
    the tabulate 'plain' output shape of print_table_result.py:95-106)."""
    models = sorted(results, key=str.lower)
    rows = [["Category"] + models]
    per_model = {m: milebench_category_averages(results[m]) for m in models}
    for category in TASK_CATEGORIES:
        rows.append([category] +
                    [f"{per_model[m][category]:.1f}" for m in models])
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(row, widths)).rstrip()
             for row in rows]
    return "\n".join(lines)


def _image_to_mdstring(image) -> str:
    from PIL import Image

    if isinstance(image, str):
        image = Image.open(image).convert("RGB")
    buffered = io.BytesIO()
    image.save(buffered, format="JPEG")
    img_str = base64.b64encode(buffered.getvalue()).decode()
    return f"![image](data:image/jpeg;base64,{img_str})"


def mm_niah_item_markdown(item: dict, image_dir: str = "") -> str:
    """One MM-NIAH annotation -> markdown (visualization.py:50-115 parity:
    meta-info header, inlined context/question images, backtick-highlighted
    text needles, A./B./... choices incl. image choices, escaped angle
    brackets)."""
    context = item["context"]
    question = item["question"]
    answer = item["answer"]
    meta = item["meta"]
    images_list = [os.path.join(image_dir, i)
                   for i in item.get("images_list", [])]

    n_ctx = context.count(IMAGE_PLACEHOLDER)
    n_total = n_ctx + question.count(IMAGE_PLACEHOLDER)
    assert n_total == len(images_list), (n_total, len(images_list))
    for i in range(n_total):
        md = _image_to_mdstring(images_list[i])
        if i < n_ctx:
            context = context.replace(IMAGE_PLACEHOLDER, md, 1)
        else:
            question = question.replace(IMAGE_PLACEHOLDER, md, 1)

    needles = meta.get("needles", [])
    choices = meta.get("choices")
    choices_image = meta.get("choices_image_path")

    if isinstance(answer, int):
        answer = chr(answer + ord("A")) if (choices or choices_image) \
            else str(answer)

    for needle in needles:
        if isinstance(needle, int):
            continue
        if needle in context:
            context = context.replace(needle, f" `{needle}` ")

    if choices:
        for c_idx, c in enumerate(choices):
            question = f"{question}\n\n{chr(c_idx + ord('A'))}. {c}"
    if choices_image:
        for c_idx, c in enumerate(choices_image):
            c = _image_to_mdstring(os.path.join(image_dir, c))
            question = f"{question}\n\n{chr(c_idx + ord('A'))}. {c}"

    if isinstance(answer, list):
        answer = json.dumps(answer)

    key_list = ["needles", "placed_depth", "context_length", "num_images"]
    md_str = "\n\n".join([
        "## Meta Info",
        *[f"{k}={meta[k]}" for k in key_list if k in meta],
        f"num_images={len(images_list)}",
        "## Context", context,
        "## Question", question,
        "## Answer", str(answer),
    ])
    return md_str.replace("<", "\\<").replace(">", "\\>")


def combine_images(image_paths: Sequence[str],
                   resize_to=(800, 800)):
    """Grid-combine images (LANCZOS resize, square-ish grid, row-major
    paste) — eval/milebench/combine_images.py:67-95 parity. Returns the
    combined PIL image."""
    import math

    from PIL import Image

    images = []
    for path in image_paths:
        with Image.open(path) as im:   # close fds promptly: whole-dataset
            images.append(im.resize(resize_to,   # runs touch thousands
                                    Image.LANCZOS).convert("RGBA"))
    grid_w = math.ceil(math.sqrt(len(images)))
    grid_h = math.ceil(len(images) / grid_w)
    out = Image.new("RGB", (grid_w * resize_to[0], grid_h * resize_to[1]))
    x = y = 0
    for img in images:
        out.paste(img, (x, y))
        x += resize_to[0]
        if x >= grid_w * resize_to[0]:
            x, y = 0, y + resize_to[1]
    return out


def combine_milebench_dataset(data_dir: str, dataset_name: str,
                              max_img_num: int) -> str:
    """Pre-combine a MileBench task's images so samples fit a model's image
    budget (combine_images.py:107-148): every ceil(n/max) consecutive
    originals merge into one grid jpg; the json gains a
    ``combined_{max}_images`` path list per sample and is rewritten as
    ``{name}_combined_{max}.json``. Returns the new json path."""
    dataset_dir = os.path.join(data_dir, dataset_name)
    img_dir = os.path.join(dataset_dir, "images")
    output_dir = os.path.join(dataset_dir, f"combined_{max_img_num}_images")
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(dataset_dir, f"{dataset_name}.json")) as f:
        json_data = json.load(f)
    for item in json_data["data"]:
        names = item["task_instance"]["images_path"]
        paths = [os.path.join(img_dir, n) for n in names]
        if not paths:  # text-only sample: nothing to combine
            item["task_instance"][f"combined_{max_img_num}_images"] = []
            continue
        combine_num = (len(paths) - 1) // max_img_num + 1
        outs = []
        for idx, start in enumerate(range(0, len(paths), combine_num)):
            name = f"{item['sample_id']}-{idx}.jpg"
            combine_images(paths[start:start + combine_num]).save(
                os.path.join(output_dir, name))
            outs.append(name)
        item["task_instance"][f"combined_{max_img_num}_images"] = outs
    out_json = os.path.join(dataset_dir,
                            f"{dataset_name}_combined_{max_img_num}.json")
    with open(out_json, "w") as f:
        json.dump(json_data, f, ensure_ascii=False, indent=4)
    return out_json


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="v2pe_tpu_torch.evalkit.report")
    sub = p.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("milebench")
    pm.add_argument("results", nargs="+",
                    help="milebench_result.json files; the model name is "
                         "the parent directory name")
    pn = sub.add_parser("mm-niah-item")
    pn.add_argument("annotation", help="jsonl annotation file")
    pn.add_argument("index", type=int)
    pn.add_argument("--image-dir", default="")
    pn.add_argument("-o", "--output", default=None)
    pc = sub.add_parser("combine-images")
    pc.add_argument("--data_dir", default="data/MileBench")
    pc.add_argument("--dataset_name", required=True)
    pc.add_argument("--max_img_num", required=True, type=int)
    args = p.parse_args(argv)

    if args.cmd == "combine-images":
        out = combine_milebench_dataset(args.data_dir, args.dataset_name,
                                        args.max_img_num)
        print(out)
        return 0

    if args.cmd == "milebench":
        results = {}
        for path in args.results:
            name = os.path.basename(os.path.dirname(os.path.abspath(path))) \
                or os.path.basename(path)
            name = name.replace("internvl2_5_8b_stage1_mammoth-", "")
            with open(path) as f:
                results[name] = json.load(f)
        print(milebench_table(results))
    else:
        with open(args.annotation) as f:
            item = json.loads(f.readlines()[args.index])
        md = mm_niah_item_markdown(item, args.image_dir)
        if args.output:
            with open(args.output, "w") as f:
                f.write(md)
        else:
            print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
