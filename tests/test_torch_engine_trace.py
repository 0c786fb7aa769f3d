"""The serving engine's spans and counters (``serve/engine.py`` through
``utils/profiling.SpanRecorder``) on a small fp32 model on the CPU.

One mix of requests (text and image prompts, two of them the same image
and question, so the second is served from the prefix cache) runs through
a 2-row engine, once with the span log off and once with it attached. The
counters must add up: every request admitted and retired once, chunk
tokens split into valid and padding, prompt tokens into prefilled and
cached, decode steps into blocks; each span's time holds its children's,
and a request's times are in order. With the log attached every logged
child lies inside its parent and carries its parent's request id; with it
off nothing is kept. A span shares ``torch.profiler``'s clock. The repeated
request's keys are taken away after its submit, so that its plan keys it
(the ``digest`` span) and still finds the first one's pages.

Keys made at submit: equal to the plan's own keying (the pixels' bytes
hashed through a copy, then ``chain_keys``) for contiguous, strided and no
pixels; the same pages shared as with keys made by the plan; the same mix
served with keys from submit keeps ``digest`` at 0 and counts every
admission in ``keyed_at_submit``; a request submitted from another thread
is keyed on that thread before the scheduler sees it; a plan retried for
want of pages hashes nothing.
"""

import hashlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from v2pe_tpu_torch.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.models.params import init_vlm_params
from v2pe_tpu_torch.serve import engine as tengine
from v2pe_tpu_torch.utils.profiling import SpanRecorder

from .test_data_pipeline import _toy_tokenizer

PAGE, CHUNK, BLOCK = 8, 64, 4
# each child span's parent
PARENT = {"plan": "step", "digest": "plan", "admit": "step",
          "pixel_upload": "admit", "vit": "admit", "prefill": "admit",
          "first_token": "admit", "decode_block": "step",
          "decode_launch": "decode_block", "harvest": "decode_block",
          "drain": "decode_block"}


def _model():
    tok = _toy_tokenizer()
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=32,
                      intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        max_dynamic_patch=2)
    model = init_vlm_params(cfg, torch.Generator().manual_seed(0)).eval()
    return ChatModel(model, cfg, tok)


def _engine(chat, **kw):
    kw = {"max_rows": 2, "max_len": 1024, "page_size": PAGE,
          "chunk_size": CHUNK, "decode_block": BLOCK, **kw}
    return tengine.InferenceEngine(chat, **kw)


def _images():
    rng = np.random.RandomState(0)
    return (rng.rand(2, 3, 56, 56).astype(np.float32),
            rng.rand(1, 3, 56, 56).astype(np.float32))


def _serve(chat, log: bool, unkeyed=(2,)):
    """The mix through a fresh engine: (engine, requests). The requests
    ``unkeyed`` lose their submit's keys, so that the plan keys them."""
    eng = _engine(chat)
    if log:
        eng.spans.record()
    img2, img1 = _images()
    subs = [(img2, "What is in the image?", 5),
            (None, "Describe the cat.", 7),
            (img2, "What is in the image?", 4),   # the prefix cache's
            (img1, "The cat is orange.", 3),
            (None, "What is in the image? A cat sitting on a mat. " * 3, 6)]
    reqs = [eng.submit_chat(px, q, max_new_tokens=n) for px, q, n in subs]
    for i in unkeyed:
        reqs[i].keys = None
    eng.run_until_idle()
    return eng, reqs


@pytest.fixture(scope="module")
def chat():
    return _model()


@pytest.fixture(scope="module")
def served(chat):
    return {log: _serve(chat, log) for log in (False, True)}


@pytest.mark.parametrize("log", [False, True])
def test_every_request_is_admitted_and_retired_once(served, log):
    eng, reqs = served[log]
    st = eng.stats
    assert st["admissions"] == st["retired"] == len(reqs)
    assert all(len(r.tokens) == r.max_new_tokens for r in reqs)


def test_chunks_split_into_valid_and_padding_tokens(served):
    eng, reqs = served[False]
    st = eng.stats
    assert st["prefill_tokens"] + st["prefill_pad_tokens"] == \
        st["prefill_chunks"] * CHUNK
    assert 0 < st["prefill_pad_tokens"] < st["prefill_chunks"] * CHUNK
    assert st["prefill_chunks"] == sum(
        -(-(len(r.ids) - r.cached_tokens) // CHUNK) for r in reqs)


def test_prompt_tokens_are_prefilled_or_cached(served):
    eng, reqs = served[False]
    st = eng.stats
    assert st["prefill_tokens"] + st["prefix_hit_tokens"] == \
        sum(len(r.ids) for r in reqs)


def test_prefix_hit_tokens_match_pages_and_requests(served):
    eng, reqs = served[False]
    st = eng.stats
    assert st["prefix_hit_tokens"] == st["prefix_hit_pages"] * PAGE == \
        sum(r.cached_tokens for r in reqs)
    # the repeated image and question hit the cache, and so does the
    # second text prompt (the template's leading pages); other images do not
    assert [r.cached_tokens > 0 for r in reqs] == \
        [False, False, True, False, True]
    assert reqs[2].cached_tokens == (len(reqs[2].ids) - 1) // PAGE * PAGE


def test_plain_decode_counts_its_steps_by_block(served):
    eng, reqs = served[False]
    st = eng.stats
    assert st["decode_steps"] == st["decode_blocks"] * BLOCK > 0
    assert st.get("spec_forwards", 0) == 0


@pytest.mark.parametrize("log", [False, True])
def test_each_span_holds_its_childrens_time(served, log):
    st = served[log][0].stats
    for name in tengine.SPANS:
        assert isinstance(st[f"{name}_ns"], int) and st[f"{name}_ns"] > 0, \
            name
    for parent in set(PARENT.values()):
        kids = [c for c, p in PARENT.items() if p == parent]
        assert st[f"{parent}_ns"] >= sum(st[f"{c}_ns"] for c in kids), parent


def test_request_times_are_in_order_and_queue_wait_adds_them_up(served):
    eng, reqs = served[False]
    for r in reqs:
        assert 0 < r.submit_ns <= r.admit_ns <= r.first_token_ns
    assert eng.stats["queue_wait_ns"] == sum(r.admit_ns - r.submit_ns
                                             for r in reqs)
    # two rows for five requests: the last ones waited for a row
    assert reqs[-1].admit_ns > reqs[0].first_token_ns


def test_logged_children_lie_inside_their_parents(served):
    eng, reqs = served[True]
    spans = eng.spans.drain()
    names = [s[0] for s in spans]
    assert set(names) == set(tengine.SPANS)
    ids = {r.request_id for r in reqs}
    for name, t0, t1, parent, rid in spans:
        assert t0 <= t1
        if name == "step":
            assert parent == -1 and rid == -1
            continue
        pname, p0, p1, _, prid = spans[parent]
        assert pname == PARENT[name] and p0 <= t0 <= t1 <= p1, name
        if name in ("plan", "admit"):
            assert rid in ids
        elif pname in ("plan", "admit"):
            assert rid == prid
        else:
            assert rid == -1
    # each request was admitted once, and its admission logged by its id
    assert sorted(s[4] for s in spans if s[0] == "admit") == sorted(ids)
    # the logged durations are what the counters added up
    for name in tengine.SPANS:
        assert sum(t1 - t0 for n, t0, t1, _, _ in spans if n == name) == \
            eng.stats[f"{name}_ns"]
    assert eng.spans.drain() == []


def test_with_the_log_off_nothing_is_kept(served):
    eng, _ = served[False]
    assert eng.spans.drain() == []
    assert eng.spans._log is None and eng.spans._open == []


def test_the_ring_keeps_the_last_spans():
    rec = SpanRecorder({})
    rec.record(3)
    with rec.span("a", 7):
        for _ in range(4):
            with rec.span("b", 7):
                pass
    got = rec.drain()
    # the ring kept the last two children and their parent, in the order
    # they opened; the parent is found in the list by its index
    assert [g[0] for g in got] == ["a", "b", "b"]
    assert [g[3] for g in got] == [-1, 0, 0]
    assert all(g[4] == 7 for g in got)
    # the counter holds every child, the ones pushed out included
    assert rec.counters["b_ns"] >= sum(g[2] - g[1] for g in got[1:])
    assert rec.counters["a_ns"] == got[0][2] - got[0][1]
    with rec.span("b"):
        inner = rec.drain()            # drained while its parent is open
    assert inner == []
    assert [g[3] for g in rec.drain()] == [-1]


def test_a_span_shares_the_profilers_clock():
    stats = {}
    rec = SpanRecorder(stats)
    rec.record()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with torch.profiler.record_function("inside"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    ((name, t0, t1, parent, rid),) = rec.drain()
    assert (name, parent, rid) == ("outer", -1, -1)
    assert stats["outer_ns"] == t1 - t0
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inside"]
    start = ev.start_ns()
    end = start + ev.duration_ns()
    assert t0 - 1_000_000 <= start <= end <= t1 + 1_000_000


def _plan_keys(ids, pos, px):
    """The keys as the plan made them before submit did: the pixels' bytes
    copied out and hashed, then chained."""
    seed = b"" if px is None else hashlib.blake2b(
        np.ascontiguousarray(px).tobytes(), digest_size=16).digest()
    return tengine.PrefixCache.chain_keys(ids, pos, PAGE, seed)


@pytest.mark.parametrize("pixels", ["contiguous", "strided", "none"])
def test_keys_made_at_submit_equal_the_plans(chat, pixels):
    img2, _ = _images()
    px = {"contiguous": img2, "strided": img2[:, :, ::-1],
          "none": None}[pixels]
    req = _engine(chat).submit_chat(px, "What is in the image?",
                                    max_new_tokens=4)
    assert req.keys == _plan_keys(req.ids, req.pos, px)
    assert len(req.keys) == len(req.ids) // PAGE > 0 and req.key_ns > 0
    if pixels == "strided":           # the view's bytes, not the base's
        assert req.keys[0] != _plan_keys(req.ids, req.pos, img2)[0]


def test_submit_keys_share_the_pages_plan_keys_share(chat):
    """Two submits of the same pixels and text: the second is served the
    same cached pages whether submit or the plan made the keys."""
    img2, _ = _images()
    got = {}
    for unkeyed in (False, True):
        eng = _engine(chat)
        reqs = [eng.submit_chat(img2, "What is in the image?",
                                max_new_tokens=4) for _ in range(2)]
        if unkeyed:
            for r in reqs:
                r.keys = None
        eng.run_until_idle()
        got[unkeyed] = (eng.stats["prefix_hit_pages"],
                        [r.cached_tokens for r in reqs],
                        [r.tokens for r in reqs])
    assert got[False] == got[True]
    assert got[False][0] == (len(reqs[1].ids) - 1) // PAGE > 0


def test_a_served_batch_is_keyed_at_submit(chat, served):
    eng, reqs = _serve(chat, False, unkeyed=())
    st = eng.stats
    assert st["digest_ns"] == 0
    assert st["keyed_at_submit"] == st["admissions"] == len(reqs)
    assert st["submit_digest_ns"] == sum(r.key_ns for r in reqs) > 0
    # the same hits and tokens as the mix whose repeat the plan keyed
    _, planned = served[False]
    assert [(r.cached_tokens, r.tokens) for r in reqs] == \
        [(r.cached_tokens, r.tokens) for r in planned]


def test_the_plan_keys_a_request_that_came_without_keys(served):
    eng, reqs = served[False]
    st = eng.stats
    assert st["digest_ns"] > 0
    assert st["keyed_at_submit"] == st["admissions"] - 1
    assert st["submit_digest_ns"] == sum(
        r.key_ns for i, r in enumerate(reqs) if i != 2)


def test_a_request_from_another_thread_is_keyed_on_it(chat, monkeypatch):
    """Submitted from a client thread while the scheduler thread runs: the
    pixels are hashed on the client thread alone, and the scheduler's plan
    finds the keys already made."""
    img2, _ = _images()
    eng = _engine(chat)
    blake2b, hashed_on, seen = hashlib.blake2b, [], []

    def counting(*a, **kw):
        hashed_on.append(threading.get_ident())
        return blake2b(*a, **kw)

    plan = eng._plan_admission

    def spy(req):
        seen.append(req.keys)
        return plan(req)

    monkeypatch.setattr(hashlib, "blake2b", counting)
    eng._plan_admission = spy
    out = {}

    def client():
        out["ident"] = threading.get_ident()
        out["req"] = eng.submit_chat(img2, "What is in the image?",
                                     max_new_tokens=3)

    eng.start()
    try:
        t = threading.Thread(target=client)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        req = out["req"]
        req.result(timeout=60)
        assert req.finished.is_set()
    finally:
        eng.stop()
    assert set(hashed_on) == {out["ident"]}
    assert seen and all(k == _plan_keys(req.ids, req.pos, img2)
                        for k in seen)
    assert len(req.tokens) == 3
    assert eng.stats["keyed_at_submit"] == 1 and eng.stats["digest_ns"] == 0


def test_a_retried_plan_hashes_nothing(chat, monkeypatch):
    """Two requests whose pages the pool cannot hold at once: the second's
    plan fails for want of pages while the first decodes, and is retried
    each step. With keys from submit no retry hashes; with none, each
    retry hashes the pixels again."""
    img2, img1 = _images()
    q = "What is in the image? " * 4
    blake2b = hashlib.blake2b
    n_ids = len(_engine(chat).submit_chat(img2, q, max_new_tokens=6).ids)
    need = -(-(n_ids + 6) // PAGE)
    for unkeyed in (False, True):
        # room for one request and a half
        eng = _engine(chat, pool_tokens=(need + need // 2) * PAGE)
        plans = []
        plan = eng._plan_admission

        def spy(req, plan=plan, plans=plans):
            out = plan(req)
            plans.append(out is not None)
            return out

        eng._plan_admission = spy
        reqs = [eng.submit_chat(px, q, max_new_tokens=6)
                for px in (img2, img1)]
        if unkeyed:
            for r in reqs:
                r.keys = None
        calls = []
        monkeypatch.setattr(
            hashlib, "blake2b",
            lambda *a, **kw: calls.append(1) or blake2b(*a, **kw))
        eng.run_until_idle()
        monkeypatch.setattr(hashlib, "blake2b", blake2b)
        assert plans.count(False) >= 2 and plans[-1]   # retried, admitted
        assert all(len(r.tokens) == 6 for r in reqs)
        if unkeyed:
            assert len(calls) >= len(plans) and eng.stats["digest_ns"] > 0
        else:
            assert calls == [] and eng.stats["digest_ns"] == 0
