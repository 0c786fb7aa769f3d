"""Dynamic high-resolution image tiling.

Behavior parity with ``internvl/train/dataset.py:730-788``
(``find_closest_aspect_ratio`` + ``dynamic_preprocess``): enumerate (i, j)
grids with min_num <= i*j <= max_num, pick by |aspect-ratio diff| with the
area tiebreak, resize to (i*S, j*S), crop row-major S x S tiles, and append
an S x S thumbnail when more than one tile."""

from __future__ import annotations

from typing import List, Optional, Tuple


def find_closest_aspect_ratio(aspect_ratio: float, target_ratios, width: int,
                              height: int, image_size: int) -> Tuple[int, int]:
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def candidate_ratios(min_num: int, max_num: int):
    ratios = set(
        (i, j)
        for n in range(min_num, max_num + 1)
        for i in range(1, n + 1)
        for j in range(1, n + 1)
        if min_num <= i * j <= max_num
    )
    return sorted(ratios, key=lambda x: x[0] * x[1])


def plan_tiles(width: int, height: int, *, min_num: int = 1,
               max_num: int = 6, image_size: int = 448,
               use_thumbnail: bool = False):
    """Pure planning half (no PIL): returns (grid_w, grid_h, num_tiles
    including thumbnail, boxes in the resized image)."""
    aspect_ratio = width / height
    ratios = candidate_ratios(min_num, max_num)
    gw, gh = find_closest_aspect_ratio(aspect_ratio, ratios, width, height,
                                       image_size)
    blocks = gw * gh
    boxes = []
    tw = image_size * gw
    for i in range(blocks):
        boxes.append((
            (i % (tw // image_size)) * image_size,
            (i // (tw // image_size)) * image_size,
            ((i % (tw // image_size)) + 1) * image_size,
            ((i // (tw // image_size)) + 1) * image_size,
        ))
    n = blocks + (1 if use_thumbnail and blocks != 1 else 0)
    return gw, gh, n, boxes


def dynamic_preprocess(image, min_num: int = 1, max_num: int = 6,
                       image_size: int = 448, use_thumbnail: bool = False,
                       return_box: bool = False):
    """PIL tiling with reference semantics. ``image`` is a PIL.Image."""
    w, h = image.size
    gw, gh, _, boxes = plan_tiles(w, h, min_num=min_num, max_num=max_num,
                                  image_size=image_size,
                                  use_thumbnail=use_thumbnail)
    resized = image.resize((image_size * gw, image_size * gh))
    tiles = [resized.crop(b) for b in boxes]
    assert len(tiles) == gw * gh
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    if return_box:
        return tiles, boxes
    return tiles
