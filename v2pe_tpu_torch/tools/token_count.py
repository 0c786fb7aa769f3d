"""Text and visual token budget of a dataset (counterpart of
``tools/token_count.py``, the reference's ``pretrained/token_count.py``).

For each dataset of a meta file (``{name: {root, annotation}}``), the
tokens of its conversations' text (the tokenizer's ids of the turns joined
by newlines) and its visual tokens (tiles x ``--num-image-token``; the
tiles of the aspect-ratio search with a thumbnail, or with ``--grid`` the
floor-division grid), summed over the samples:

    python -m v2pe_tpu_torch.tools.token_count --meta meta.json \
        --tokenizer <tokenizer dir> [--num-image-token 256] [--grid] \
        [--workers 8] [--limit N]

Host code only (no card): the port's copies of ``data/``.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor


def grid_tiles(w: int, h: int, image_size: int = 448) -> int:
    """The grid variant: floor-division tiling, at least one tile."""
    return max(w // image_size, 1) * max(h // image_size, 1)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--meta", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--num-image-token", type=int, default=256)
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--max-num", type=int, default=12)
    p.add_argument("--grid", action="store_true",
                   help="grid tiling variant instead of aspect-ratio search")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--limit", type=int, default=0)
    return p


def main(argv=None, tokenizer=None):
    """Print one line a dataset. ``tokenizer``: used as it is in place of
    loading ``--tokenizer``."""
    args = build_argparser().parse_args(argv)
    from v2pe_tpu_torch.data.datasets import load_image
    from v2pe_tpu_torch.data.tiling import plan_tiles

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer,
                                                  trust_remote_code=True)
    with open(args.meta) as f:
        metas = json.load(f)

    def count_one(root, item):
        text = "\n".join(c["value"] for c in item.get("conversations", []))
        n_text = len(tokenizer(text)["input_ids"])
        field = item.get("image")
        paths = [] if not field else field if isinstance(field, list) \
            else [field]
        n_vis = 0
        for rel in paths:
            w, h = load_image(os.path.join(root, rel)).size
            n = grid_tiles(w, h, args.image_size) if args.grid else \
                plan_tiles(w, h, max_num=args.max_num,
                           image_size=args.image_size,
                           use_thumbnail=True)[2]
            n_vis += n * args.num_image_token
        return n_text, n_vis

    for name, meta in metas.items():
        root = meta.get("root", "") or ""
        with open(meta["annotation"]) as f:
            items = [json.loads(line) for line in f]
        if args.limit:
            items = items[:args.limit]
        with ThreadPoolExecutor(max_workers=args.workers) as ex:
            results = list(ex.map(lambda it: count_one(root, it), items))
        text_tok = sum(r[0] for r in results)
        vis_tok = sum(r[1] for r in results)
        print(f"[{name}] samples={len(items)} text_tokens={text_tok} "
              f"visual_tokens={vis_tok} "
              f"avg_total={(text_tok + vis_tok) / max(len(items), 1):.0f}")


if __name__ == "__main__":
    main()
