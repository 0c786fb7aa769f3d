"""Each traffic mix is the same for the same seed, keeps to its ranges, and
gives every seed the same sizes in the same order."""

import glob
import json
import os

import numpy as np
import pytest

from portbench.lib import traffic
from portbench.lib.tokenizer import CodePointTokenizer
from portbench.reference import rules

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = sorted(os.path.basename(p)[:-5]
               for p in glob.glob(os.path.join(HERE, "traffic", "*.json")))
SEEDS = (7, 2 ** 31 + 12345, 3 * 10 ** 9)


def _mix(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _requests(mix, seed, rounds=None):
    m = traffic.Mix(mix, seed)
    return [m.request(c, r, q) for r in range(rounds or mix["rounds"] + 1)
            for c in range(mix["clients"])
            for q in range(mix["questions_per_document"])]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a, b = _requests(mix, SEEDS[1]), _requests(mix, SEEDS[1])
    for x, y in zip(a, b):
        assert (x.text, x.tiles, x.max_new, x.stamp) == \
            (y.text, y.tiles, y.max_new, y.stamp)
        np.testing.assert_array_equal(x.offsets, y.offsets)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_change_inputs_not_sizes(name):
    mix = _mix(name)
    runs = [_requests(mix, s) for s in SEEDS]
    for reqs in runs[1:]:
        assert [(r.tiles, len(r.text), r.max_new) for r in reqs] == \
            [(r.tiles, len(r.text), r.max_new) for r in runs[0]]
        assert sum(x.text != y.text for x, y in zip(reqs, runs[0])) \
            == len(reqs)


@pytest.mark.parametrize("name", MIXES)
def test_requests_keep_to_ranges(name):
    mix = _mix(name)
    d = mix["document"]
    conf = json.load(open(os.path.join(HERE, "configs",
                                       "internvl2-2b.json")))
    tok = CodePointTokenizer()
    eng = mix["engine"]
    for req in _requests(mix, SEEDS[2]):
        assert d["images"][0] <= len(req.tiles) <= d["images"][1]
        assert sum(req.tiles) <= d["max_tiles"]
        assert all(1 <= t <= d["max_tiles_per_image"] + 1 for t in req.tiles)
        assert mix["answer_tokens"][0] <= req.max_new <= \
            mix["answer_tokens"][1]
        doc, question = req.text.rsplit("\n", 1)
        assert mix["question_tokens"][0] <= len(question) <= \
            mix["question_tokens"][1]
        text = doc.replace("<image>\n", "")
        assert d["text_tokens"][0] <= len(text) <= d["text_tokens"][1]
        assert ((req.offsets >= 0) & (req.offsets < mix["bank_tiles"])
                ).all()
        ids = tok.encode(rules.prompt_text(conf["template"], req.text,
                                           req.tiles, 256))
        assert len(ids) + req.max_new <= eng["max_len"]


@pytest.mark.parametrize("name", MIXES)
def test_pool_is_stratified(name):
    """Every stratum of the number of images and of the text length is
    drawn once in each n-th of the pool's range."""
    mix = _mix(name)
    pool = traffic.shape_pool(mix)
    n = len(pool)
    lo, hi = mix["document"]["images"]
    counts = np.bincount([len(d.tiles) for d in pool], minlength=hi + 1)
    assert counts[lo:hi + 1].min() >= n // (hi - lo + 1) - 1
    t = np.log([d.text_tokens for d in pool])
    lo_t, hi_t = np.log(mix["document"]["text_tokens"])
    bins = np.floor((t - lo_t) / (hi_t - lo_t + 1e-9) * n).astype(int)
    assert sorted(bins.clip(0, n - 1)) == list(range(n)) or \
        len(set(bins)) >= n - 2


def test_tiles_rule():
    # a square image is one tile; wide images take wide grids and a
    # thumbnail; the grid keeps to max_num
    assert rules.tiles_for(448, 448, 12) == 1
    assert rules.tiles_for(896, 448, 12) == 3
    assert rules.tiles_for(2688, 448, 12) == 7
    assert rules.tiles_for(2688, 2688, 12) == 10
    assert rules.tiles_for(2688, 2688, 4) == 5
    for w in range(448, 2689, 97):
        for h in range(448, 2689, 131):
            assert rules.tiles_for(w, h, 5) <= 6


def test_pixels_are_the_documents_own():
    mix = _mix(MIXES[0])
    mix = dict(mix, bank_tiles=3)
    bank = np.random.default_rng(0).standard_normal(
        (3, 3, 8, 8), dtype=np.float32)
    m = traffic.Mix(mix, 5)
    a, b = m.request(0, 0, 0), m.request(1, 0, 0)
    pa, pb = traffic.pixels(bank, a), traffic.pixels(bank, b)
    assert pa.shape[0] == sum(a.tiles)
    assert pa[0, 0, 0, 0] != pb[0, 0, 0, 0]
    np.testing.assert_array_equal(pa[1:], bank[a.offsets[1:]])
