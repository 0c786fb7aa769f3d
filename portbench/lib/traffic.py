"""The one generator of serving traffic, driven by a mix's data file.

A mix is a closed loop of ``clients``: each works through documents, one
after another, and asks ``questions_per_document`` questions of each, the
next as soon as the last answer is complete. A document is 1 or more
images, each tiled by InternVL's rule at an aspect ratio drawn for it,
then text; a request is the document, then one question.

Every seed gets the same sizes in the same order: the documents' shapes
form a pool drawn once from the mix's own ``shape_seed`` (stratified over
the number of images, the text length and the answer lengths), and round r
of the loop hands block r mod ``rounds`` of the pool, ``clients``
documents, to the clients in an order also drawn from ``shape_seed``. The
run's seed draws the text, the questions, and which tiles of a bank drawn
from it fill each image; so two seeds give other inputs and the same work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from portbench.reference.rules import tiles_for

CJK = (0x4E00, 0x9FA5)  # one character, one token


@dataclasses.dataclass
class Doc:
    sizes: List[Tuple[int, int]]     # (width, height) of each image
    tiles: List[int]                 # tiles of each image
    text_tokens: int
    questions: List[Tuple[int, int]]  # (question tokens, answer tokens)


@dataclasses.dataclass
class Request:
    client: int
    round: int
    question: int
    text: str             # the user turn, with one <image> a image
    tiles: List[int]
    offsets: np.ndarray   # the bank tiles of the document, in order
    stamp: float          # written into pixel [0, 0, 0, 0]: a document's
                          # pixels are its own
    max_new: int


def _stratified(rng, n: int) -> np.ndarray:
    """n draws in [0, 1), one from each n-th of the range, shuffled."""
    return (rng.permutation(n) + rng.random(n)) / n


def _log_uniform(u, lo: int, hi: int) -> np.ndarray:
    return np.floor(np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo)))
                    ).astype(int).clip(lo, hi)


def _uniform(u, lo: int, hi: int) -> np.ndarray:
    return (lo + np.floor(u * (hi - lo + 1))).astype(int).clip(lo, hi)


def shape_pool(mix: dict) -> List[Doc]:
    """The mix's documents, from its ``shape_seed`` alone."""
    d = mix["document"]
    n = mix["clients"] * mix["rounds"]
    q_n = mix["questions_per_document"]
    rng = np.random.default_rng(mix["shape_seed"])
    n_img = _uniform(_stratified(rng, n), *d["images"])
    text = _log_uniform(_stratified(rng, n), *d["text_tokens"])
    answers = _uniform(_stratified(rng, n * q_n), *mix["answer_tokens"])
    questions = _uniform(rng.random(n * q_n), *mix["question_tokens"])
    lo, hi = d["image_side"]
    docs = []
    for i in range(n):
        k = int(n_img[i])
        # a request keeps to max_tiles: each image's grid to its share,
        # less its thumbnail
        max_num = max(1, min(d["max_tiles_per_image"],
                             d["max_tiles"] // k - int(d["thumbnail"])))
        sides = np.floor(np.exp(rng.uniform(np.log(lo), np.log(hi),
                                            (k, 2)))).astype(int)
        sizes = [(int(w), int(h)) for w, h in sides]
        docs.append(Doc(
            sizes=sizes,
            tiles=[tiles_for(w, h, max_num, thumbnail=d["thumbnail"])
                   for w, h in sizes],
            text_tokens=int(text[i]),
            questions=[(int(questions[i * q_n + j]),
                        int(answers[i * q_n + j])) for j in range(q_n)]))
    return docs


def _chars(rng, n: int) -> str:
    return "".join(map(chr, rng.integers(CJK[0], CJK[1], n)))


class Mix:
    """The requests of one run: ``request(client, round, question)``."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.pool = shape_pool(mix)
        self.clients = mix["clients"]
        self.rounds = mix["rounds"]
        self.bank_tiles = mix["bank_tiles"]
        self._order = {}
        self._text = {}

    def doc(self, client: int, rnd: int) -> Doc:
        block = rnd % self.rounds
        if rnd not in self._order:
            rng = np.random.default_rng([self.mix["shape_seed"], 1, rnd])
            self._order[rnd] = rng.permutation(self.clients)
        return self.pool[block * self.clients + int(self._order[rnd][client])]

    def _doc_text(self, client: int, rnd: int):
        key = (client, rnd)
        if key not in self._text:
            doc = self.doc(client, rnd) if client >= 0 else self.largest()
            rng = np.random.default_rng([self.seed, 2, client + 1, rnd])
            offsets = rng.integers(0, self.bank_tiles, sum(doc.tiles))
            text = "<image>\n" * len(doc.tiles) + _chars(rng, doc.text_tokens)
            qs = [_chars(rng, q) for q, _ in doc.questions]
            self._text[key] = (doc, text, qs, offsets)
        return self._text[key]

    def request(self, client: int, rnd: int, question: int) -> Request:
        doc, text, qs, offsets = self._doc_text(client, rnd)
        return Request(client=client, round=rnd, question=question,
                       text=text + "\n" + qs[question], tiles=list(doc.tiles),
                       offsets=offsets,
                       stamp=float(1000 + (client + 1) * 100000 + rnd),
                       max_new=doc.questions[question][1])

    def largest(self) -> Doc:
        """The pool's document with the most tiles and text, asked the
        longest answer: the warm-up's shape."""
        doc = max(self.pool, key=lambda d: (sum(d.tiles), d.text_tokens))
        asked = [q for d in self.pool for q in d.questions]
        longest = (max(q for q, _ in asked), max(a for _, a in asked))
        return dataclasses.replace(doc, questions=[longest]
                                   * len(doc.questions))

    def warmup(self) -> List[Request]:
        """The largest document, once cold and, when the mix asks more
        than one question of a document, once more over its prefix."""
        n = min(2, self.mix["questions_per_document"])
        return [self.request(-1, 0, j) for j in range(n)]


def tile_bank(mix: dict, seed: int, device, image_size: int = 448
              ) -> np.ndarray:
    """``bank_tiles`` normalised tiles (T, 3, S, S) float32, drawn on the
    device from the seed and kept on the host, where requests carry
    them."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) + 0x5EED) % (1 << 63))
    bank = torch.randn((mix["bank_tiles"], 3, image_size, image_size),
                       generator=g, device=device, dtype=torch.float32)
    return bank.cpu().numpy()


def pixels(bank: np.ndarray, req: Request) -> Optional[np.ndarray]:
    """The request's tiles (T, 3, S, S) float32, a new array."""
    if not req.tiles:
        return None
    out = np.take(bank, req.offsets, axis=0)
    out[0, 0, 0, 0] = np.float32(req.stamp)
    return out
