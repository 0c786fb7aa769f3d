"""Image transforms (host-side, numpy/PIL).

Parity with ``internvl/train/dataset.py:283-332`` (``build_transform``):
train = RGB -> random JPEG degrade (quality 75..100) -> bicubic resize to
S x S -> ToTensor -> normalize; eval drops the augmentation and optionally
pads to square first (``expand2square``, :269-280)."""

from __future__ import annotations

import io
import random as _random
from typing import Optional

import numpy as np

from v2pe_tpu_torch.data.constants import (CLIP_MEAN, CLIP_STD, IMAGENET_MEAN,
                                     IMAGENET_STD, SIGLIP_MEAN, SIGLIP_STD)

_NORMS = {
    "imagenet": (IMAGENET_MEAN, IMAGENET_STD),
    "clip": (CLIP_MEAN, CLIP_STD),
    "siglip": (SIGLIP_MEAN, SIGLIP_STD),
}


def jpeg_degrade(img, quality: int):
    from PIL import Image

    with io.BytesIO() as out:
        img.convert("RGB").save(out, format="JPEG", quality=quality)
        out.seek(0)
        return Image.open(out).copy()


def expand2square(img, background_color):
    from PIL import Image

    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    result = Image.new(img.mode, (side, side), background_color)
    result.paste(img, ((side - w) // 2 if h > w else 0,
                       (side - h) // 2 if w > h else 0))
    return result


def to_tensor_normalized(img, mean, std) -> np.ndarray:
    """PIL -> float32 CHW in [0,1] then normalize."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = arr.transpose(2, 0, 1)
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)
    return (arr - mean) / std


def build_transform(is_train: bool, input_size: int, pad2square: bool = False,
                    normalize_type: str = "imagenet",
                    rng: Optional[_random.Random] = None):
    """Returns a PIL.Image -> np.float32 (3, S, S) callable."""
    from PIL import Image

    mean, std = _NORMS[normalize_type]

    def transform(img):
        if img.mode != "RGB":
            img = img.convert("RGB")
        if is_train:
            q = (rng or _random).choice(range(75, 101))
            img = jpeg_degrade(img, q)
        elif pad2square:
            img = expand2square(img, tuple(int(x * 255) for x in mean))
        img = img.resize((input_size, input_size), Image.BICUBIC)
        return to_tensor_normalized(img, mean, std)

    return transform
