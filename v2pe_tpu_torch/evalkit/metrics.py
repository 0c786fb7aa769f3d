"""Evaluation metrics.

Semantics ported from the reference's scorers:
* VQA fuzzy matching — ``eval/mm_niah/tools.py:44-287`` (``VQAEval``:
  contraction/number normalization, punctuation stripping, whole-word match);
* MM-NIAH answer matching — ``eval/mm_niah/calculate_scores.py:19-91``
  (``is_correct``: int = multiple-choice letter, list = JSON sequence
  element-wise, str = normalized exact then fuzzy);
* ANLS — Long-VQA's due_evaluator (docvqa/infovqa standard: 1 - normalized
  Levenshtein, thresholded at 0.5);
* relaxed accuracy — ChartQA standard (5% numeric tolerance).
"""

from __future__ import annotations

import json
import re
from copy import deepcopy
from typing import List, Sequence, Union

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_MANUAL_MAP = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
    "seventy": 70, "eighty": 80, "ninety": 90,
}

_ARTICLES = ["a", "an", "the"]
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
          "_", "-", ">", "<", "@", "`", ",", "?", "!"]


def has_word(sentence: str, word: str) -> bool:
    return re.search(r"\b" + re.escape(word) + r"\b", sentence) is not None


class VQAEval:
    """Fuzzy VQA matcher (tools.py:44-287 semantics)."""

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def _normalize(self, text: str) -> str:
        text = self.word_tokenize(str(text))
        text = text.replace("\n", " ").replace("\t", " ").strip()
        text = self.process_punctuation(text)
        text = self.process_digit_article(text)
        return text

    def evaluate(self, answer: str, gt_answers) -> int:
        answer = self._normalize(answer)
        if isinstance(gt_answers, list):
            for gt in gt_answers:
                if has_word(answer, self._normalize(gt)):
                    return 1
            return 0
        return 1 if has_word(answer, self._normalize(gt_answers)) else 0

    def evaluate_MRR(self, answer: str, gt_answers: Sequence[str]) -> float:
        answer = self._normalize(answer)
        for i, gt in enumerate(gt_answers):
            if has_word(answer, self._normalize(gt)):
                return 1.0 / (i + 1)
        return 0.0

    def process_punctuation(self, text: str) -> str:
        out = text
        for p in _PUNCT:
            if (p + " " in text or " " + p in text) or \
                    re.search(_COMMA_STRIP, text) is not None:
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        return _PERIOD_STRIP.sub("", out, re.UNICODE)

    def process_digit_article(self, text: str) -> str:
        out = []
        for word in text.lower().split():
            word = _MANUAL_MAP.get(word, word)
            if word not in _ARTICLES:
                out.append(word)
        out = [str(w) for w in out]
        for i, word in enumerate(out):
            if word in _CONTRACTIONS:
                out[i] = _CONTRACTIONS[word]
        return " ".join(out)


_vqa = VQAEval()


def _strip_answer(text: str) -> str:
    t = text.lower().replace("the answer is", "").replace("*", "")
    if t.find(".") != -1:
        t = t.split(".")[0].replace(",", "").strip()
    return t.strip()


def mmniah_is_correct(answer, response) -> float:
    """calculate_scores.py:19-91."""
    response = str(response).strip(".")
    if isinstance(answer, int) and not isinstance(answer, bool):
        if response.isdigit():
            return float(int(response) == answer)
        r = _strip_answer(response)
        if r == "none":
            return 0.0
        if "the camera is moving left" in r or r == "left":
            r = "a"
        elif "the camera is moving right" in r or r == "right":
            r = "b"
        if len(r) != 1:
            return 0.0
        return float((ord(r) - ord("a")) == answer)

    if isinstance(answer, list):
        try:
            r = response.replace("json", "").replace("```", "").strip()
            r = json.loads(r)
            if isinstance(r, dict):
                r = sum(list(r.values()), start=[])
        except Exception:
            return 0.0
        if not isinstance(r, (list, tuple)):
            return 0.0
        match = sum(a == b for a, b in zip(r, answer))
        return match / len(answer)

    r = _strip_answer(deepcopy(response))
    a = _strip_answer(deepcopy(str(answer)))
    if r == a:
        return 1.0
    return float(_vqa.evaluate(response, answer))


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(prediction: str, gt_answers: Sequence[str],
         threshold: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity (docvqa/infovqa)."""
    best = 0.0
    pred = " ".join(str(prediction).strip().lower().split())
    for gt in gt_answers:
        gt = " ".join(str(gt).strip().lower().split())
        denom = max(len(pred), len(gt))
        if denom == 0:
            sim = 1.0 if pred == gt else 0.0
        else:
            nld = levenshtein(pred, gt) / denom
            sim = 1.0 - nld if nld < threshold else 0.0
        best = max(best, sim)
    return best


def relaxed_accuracy(prediction: str, target: str,
                     max_relative_change: float = 0.05) -> bool:
    """ChartQA relaxed correctness: numbers within 5%, else exact match."""

    def to_float(t):
        try:
            if str(t).endswith("%"):
                return float(str(t).rstrip("%")) / 100.0
            return float(t)
        except ValueError:
            return None

    p, t = to_float(prediction), to_float(target)
    if p is not None and t is not None:
        if t == 0:
            return p == t
        return abs(p - t) / abs(t) <= max_relative_change
    return str(prediction).lower().strip() == str(target).lower().strip()


def exact_match_mc(prediction: str, answer: str,
                   options: Sequence[str] = ()) -> bool:
    """Multiple-choice matching: letter match or option-text match."""
    p = str(prediction).strip().upper()
    a = str(answer).strip().upper()
    if p == a:
        return True
    if p[:1] == a and (len(p) == 1 or not p[1:2].isalnum()):
        return True
    if options:
        try:
            idx = ord(a) - ord("A")
            opt = str(options[idx]).strip().lower()
            return opt in str(prediction).strip().lower()
        except (IndexError, ValueError):
            return False
    return False
