"""Serving helpers (port of ``v2pe_tpu/serve/mm_utils.py``): base64 image
decode and keyword-based stopping. PIL is imported only when an image is
decoded or encoded."""

from __future__ import annotations

import base64
import io
from typing import Sequence


def load_image_from_base64(image_b64: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(image_b64)))


def image_to_base64(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


class KeywordsStoppingCriteria:
    """Stop when any keyword appears in the generated text."""

    def __init__(self, keywords: Sequence[str]):
        self.keywords = list(keywords)

    def should_stop(self, text: str) -> bool:
        return any(k in text for k in self.keywords if k)

    def trim(self, text: str) -> str:
        for k in self.keywords:
            if k and k in text:
                text = text.split(k)[0]
        return text
