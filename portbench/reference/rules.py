"""Frozen copies of the rules that turn a request into model inputs,
written from InternVL's published code, kept here so that the reference
works them out again without the program:

* ``tiles_for``: InternVL's dynamic-resolution tiling (the grid whose
  aspect ratio is closest to the image's, ties to the larger grid when
  the image has the area for it; a thumbnail tile when the grid has more
  than one tile);
* ``prompt_text``: the MPT chat template with each ``<image>`` marker
  expanded to ``<img>``, 256 ``<IMG_CONTEXT>`` a tile, ``</img>``;
* ``v2pe_positions``: V2PE's position ids, integer steps for text and
  steps of ``stride / 256`` inside each image, the cursor moving to the
  ceiling of the last image position.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def tiles_for(width: int, height: int, max_num: int, image_size: int = 448,
              thumbnail: bool = True, min_num: int = 1) -> int:
    ratios = sorted({(i, j) for n in range(min_num, max_num + 1)
                     for i in range(1, n + 1) for j in range(1, n + 1)
                     if min_num <= i * j <= max_num},
                    key=lambda r: r[0] * r[1])
    aspect = width / height
    best, best_diff = (1, 1), float("inf")
    for r in ratios:
        diff = abs(aspect - r[0] / r[1])
        if diff < best_diff:
            best, best_diff = r, diff
        elif diff == best_diff and \
                width * height > 0.5 * image_size * image_size * r[0] * r[1]:
            best = r
    n = best[0] * best[1]
    return n + 1 if thumbnail and n != 1 else n


def prompt_text(template: dict, question: str, tiles: Sequence[int],
                image_tokens: int) -> str:
    """The one-turn prompt: system, user question, assistant cue."""
    sep = template["sep"]
    user, assistant = template["roles"]
    text = (template["system_template"].format(
        system_message=template["system_message"]) + sep
        + user + question + sep + assistant)
    for n in tiles:
        text = text.replace(
            "<image>", "<img>" + "<IMG_CONTEXT>" * (image_tokens * n)
            + "</img>", 1)
    return text


def v2pe_positions(ids: np.ndarray, context_id: int, stride: int,
                   image_tokens: int) -> np.ndarray:
    """float32 (S,) positions of one sequence whose images are runs of
    ``context_id``."""
    ids = np.asarray(ids)
    out = np.empty(len(ids), np.float32)
    step = stride / image_tokens
    cur = -1
    i = 0
    while i < len(ids):
        if ids[i] == context_id:
            j = i
            while j < len(ids) and ids[j] == context_id:
                j += 1
            k = np.arange(1, j - i + 1, dtype=np.float64)
            vis = (np.float64(cur) + k * np.float64(step)).astype(np.float32)
            out[i:j] = vis
            cur = int(math.ceil(float(vis[-1])))
            i = j
        else:
            cur += 1
            out[i] = cur
            i += 1
    return out
