"""The benchmark's tokenizer: a character is one token.

The InternLM2 tokenizer cannot be fetched here, and the benchmark needs
exact token counts, so each character maps to its code point + 3 (0-2 are
unk, bos and eos; code points from ``LIMIT`` map to unk) and the chat and
image special tokens, matched first, take InternLM2's ids 92542-92546.
The program and the reference get the same object."""

from __future__ import annotations

import re


class CodePointTokenizer:
    NAMES = ("<|im_end|>", "<|im_start|>", "<img>", "</img>",
             "<IMG_CONTEXT>")

    def __init__(self, vocab_size: int = 92553):
        first = min(92542, vocab_size - 1 - len(self.NAMES))
        self.SPECIAL = {n: first + i for i, n in enumerate(self.NAMES)}
        self.LIMIT = min(92000, first)
        self._split = re.compile(
            "(" + "|".join(re.escape(s) for s in self.SPECIAL) + ")")

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.SPECIAL[token]

    def encode(self, text: str) -> list:
        ids = [1]  # bos
        for part in self._split.split(text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
            else:
                ids.extend(ord(c) + 3 if ord(c) + 3 < self.LIMIT else 0
                           for c in part)
        return ids

    def __call__(self, text: str) -> dict:
        return {"input_ids": self.encode(text)}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self.SPECIAL.items()}
        out = []
        for i in ids:
            if 3 <= i < self.LIMIT:
                out.append(chr(i - 3))
            elif i in inv and not skip_special_tokens:
                out.append(inv[i])
        return "".join(out)
