"""Tile-count distribution of a dataset's images (counterpart of
``tools/test_image_patch.py``, the reference's
``pretrained/test_image_patch.py``): for each dataset of a meta file
(``{name: {root, annotation}}``), the tiles the aspect-ratio search with a
thumbnail gives each image of its first ``--limit`` samples with images:

    python -m v2pe_tpu_torch.tools.test_image_patch --meta meta.json \
        [--max-num 12] [--image-size 448] [--limit 500]

Host code only (no card): the port's copies of ``data/``.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--meta", required=True,
                   help="dataset meta json ({name: {root, annotation}})")
    p.add_argument("--max-num", type=int, default=12)
    p.add_argument("--image-size", type=int, default=448)
    p.add_argument("--limit", type=int, default=500)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from v2pe_tpu_torch.data.datasets import load_image
    from v2pe_tpu_torch.data.tiling import plan_tiles

    with open(args.meta) as f:
        metas = json.load(f)
    for name, meta in metas.items():
        counts = Counter()
        root = meta.get("root", "") or ""
        n_done = 0
        with open(meta["annotation"]) as f:
            for line in f:
                if n_done >= args.limit:
                    break
                field = json.loads(line).get("image")
                if not field:
                    continue
                for rel in field if isinstance(field, list) else [field]:
                    w, h = load_image(os.path.join(root, rel)).size
                    counts[plan_tiles(w, h, max_num=args.max_num,
                                      image_size=args.image_size,
                                      use_thumbnail=True)[2]] += 1
                n_done += 1
        total = sum(counts.values())
        print(f"[{name}] images={total} tile distribution:")
        for k in sorted(counts):
            print(f"  {k:3d} tiles: {counts[k]:6d} "
                  f"({100.0 * counts[k] / total:.1f}%)")


if __name__ == "__main__":
    main()
