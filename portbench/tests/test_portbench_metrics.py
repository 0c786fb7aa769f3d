"""The end-to-end metrics against sums by hand over a made-up run."""

import math

import pytest

from portbench.lib import spec, stats


def _metric(name):
    return spec.load_module("metrics", name).read


def _run(requests, t0=100.0, t1=110.0, unfinished=0):
    return {"t0": t0, "t_end": t1, "requests": requests,
            "unfinished": unfinished, "setup_s": 12.5}


def _req(submit, times, prompt, error=None):
    return {"submit": submit, "times": times, "prompt": prompt,
            "done": times[-1] if times else None, "error": error,
            "new": len(times)}


def test_percentile_nearest_rank_keeps_ten_beyond():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert sum(x > stats.percentile(v, 90) for x in v) == 10
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([], 90) is None


def test_serve_tok_s_counts_the_window_only():
    reqs = [
        # first token before the window: its prompt does not count, its
        # two tokens inside do
        _req(95.0, [99.0, 101.0, 102.0], 1000),
        # wholly inside: prompt and three tokens
        _req(101.0, [103.0, 104.0, 105.0], 700),
        # first token inside, last after the window
        _req(108.0, [109.0, 111.0], 300),
    ]
    want = (700 + 300 + 2 + 3 + 1) / 10.0
    assert _metric("serve_tok_s")(_run(reqs)) == pytest.approx(want)


def test_ttft_p90_over_requests_sent_in_the_window():
    reqs = [_req(100.0 + i * 0.05, [100.0 + i * 0.05 + 0.01 * (i + 1), 112.0],
                 10) for i in range(100)]
    reqs.append(_req(99.0, [109.0], 10))          # sent before: left out
    got = _metric("ttft_p90_ms")(_run(reqs))
    assert got == pytest.approx(10.0 * 90)        # the 90th of 10..1000 ms
    # a failed request is missing, so counts as infinitely late
    reqs[0] = _req(100.0, [100.5], 10, error="boom")
    ttft = sorted([(r["times"][0] - r["submit"]) * 1e3 if r["error"] is None
                   else math.inf for r in reqs if r["submit"] >= 100.0])
    assert _metric("ttft_p90_ms")(_run(reqs)) == pytest.approx(ttft[89])


def test_ttft_none_when_the_tail_never_came():
    reqs = [_req(101.0, [102.0], 1)] * 5
    assert _metric("ttft_p90_ms")(_run(reqs, unfinished=5)) is None


def test_tpot_p90_of_requests_completed_in_the_window():
    reqs = []
    for i in range(20):
        step = 0.01 * (i + 1)
        reqs.append(_req(100.0, [101.0 + k * step for k in range(11)], 5))
    reqs.append(_req(100.0, [108.0, 120.0], 5))   # completes after: left out
    got = _metric("tpot_p90_ms")(_run(reqs))
    assert got == pytest.approx(0.01 * 18 * 1e3)  # 18th of 20 (10..200 ms)


def test_setup_s():
    assert _metric("setup_s")(_run([])) == 12.5


def test_per_layer_metrics_read_nothing_from_an_untraced_run():
    run = _run([])
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert _metric(m["name"])(run) is None, m["name"]


def test_traced_shares():
    t = {"busy_s": 6.0, "window_s": 10.0, "flops": 989e12 * 0.5,
         "prefill_roof_s": 0.2, "decode_bytes": 3.35e12 * 0.1,
         "decode_attn_flops": 1.0,
         "kernel_s": {"void flash_fwd_tc_kernel<64>": 0.3,
                      "paged_prefill_tc_kernel<bf16>": 0.5,
                      "paged_decode_kernel<bf16>": 0.4, "nvjet": 9.0},
         "kernel_n": {"void flash_fwd_tc_kernel<64>": 3,
                      "paged_prefill_tc_kernel<bf16>": 2,
                      "paged_decode_kernel<bf16>": 4, "nvjet": 1},
         "launches": {"flash_fwd": 3, "paged_prefill": 2, "paged_decode": 4}}
    # two requests admitted in the window, 1000 prompt tokens each, one
    # page of 512 served by the prefix cache; one before the window
    run = _run([_req(99.0, [100.5, 101.0], 1000),
                _req(101.0, [102.0, 103.0], 1000),
                _req(98.0, [99.0], 1000)])
    run.update(traced=t, stats={"prefix_hit_pages": 1}, page_size=512,
               window_peak_bytes=3 * 2 ** 30)
    assert _metric("device_idle_pct.serve")(run) == pytest.approx(40.0)
    assert _metric("mfu.serve")(run) == pytest.approx(5.0)
    assert _metric("attn_prefill_roofline.serve")(run) == \
        pytest.approx(25.0)
    assert _metric("attn_decode_roofline.serve")(run) == \
        pytest.approx(25.0)
    assert _metric("prefix_hit_pct.serve")(run) == pytest.approx(25.6)
    assert _metric("peak_gib.serve")(run) == pytest.approx(3.0)
    # a trace that lost launches the counters saw gives no share
    t["launches"]["paged_decode"] = 5
    assert _metric("attn_decode_roofline.serve")(run) is None


def test_idle_gaps_named_by_the_span_they_fell_in():
    from portbench.lib import trace

    class Fake:
        host_start_ns, host_end_ns, wall_s = 0, 100, 1e-7

        def events(self):
            return [("k1", 10, 20), ("k2", 15, 30), ("k3", 50, 60)]

    spans = [("admit", 0, 12), ("decode_block", 35, 70)]
    got = trace.summarize(Fake(), spans)
    assert got["busy_s"] == pytest.approx(30e-9)
    # gaps: 0-10 (admit), 30-50 (mid 40: decode_block), 60-100 (mid 80:
    # no span)
    assert got["idle_s"] == pytest.approx(
        {"admit": 10e-9, "decode_block": 20e-9, "scheduler": 40e-9})
    assert got["kernel_n"] == {"k1": 1, "k2": 1, "k3": 1}


def test_traced_work_from_the_requests_and_the_hit_counter():
    """The traced steps' work: requests admitted between the trace's two
    ends are prefilled less their prefix hits, and every token after the
    first that arrived between them is decoded; a hit the admissions'
    readings did not see leaves the work uncounted."""
    import types

    import numpy as np

    from portbench.drivers import serve
    from portbench.lib import work
    from tiny import tiny_config

    sizes = work.Sizes(tiny_config()["model"])
    ctx, page, chunk = 7, 16, 64

    def req(rid, S, n_img, pixels=True):
        ids = np.ones(S, np.int64)
        ids[2:2 + n_img] = ctx
        return types.SimpleNamespace(
            request_id=rid, ids=ids, tokens=[],
            pixel_values=np.zeros(1) if pixels else None)

    class Eng:
        stats = {"prefix_hit_pages": 0}
        hits = {}

        def step(self):
            return True

        def _plan_admission(self, r):
            self.stats["prefix_hit_pages"] += self.hits.get(r.request_id, 0)
            return ()

    eng = Eng()
    a, b, c = req(1, 100, 40), req(2, 200, 40), req(3, 90, 30)
    d = req(4, 50, 0, False)
    eng.hits = {2: 3}
    live = {}
    records = [types.SimpleNamespace(engine_req=None)]
    t = serve.Tracer(eng, sizes, records, live, serve.threading.Lock(),
                     ctx, "cpu")
    a.tokens = [5, 5]                      # decoding before the trace
    live.update({1: a, 2: b})
    t._snapshot()
    eng._plan_admission(b)                 # b: 48 of its 200 from pages
    b.tokens = [5, 5, 5]
    a.tokens += [5, 5]
    live.update({3: c, 4: d})
    for r in (c, d):
        eng._plan_admission(r)
        r.tokens = [5]
    t._snapshot()
    got = t.work(chunk, page)
    f_b, r_b = sizes.prefill(200, 48, chunk, 0)   # its 40 image tokens cached
    f_c, r_c = sizes.prefill(90, 0, chunk, -(-30 // sizes.image_tokens))
    f_d, r_d = sizes.prefill(50, 0, chunk, 0)
    dec = [sizes.decode_token(S + k - 1) for S, k in
           ((100, 3), (100, 4), (200, 2), (200, 3))]
    assert got["flops"] == pytest.approx(
        f_b + f_c + f_d + sum(x[0] for x in dec))
    assert got["prefill_roof_s"] == pytest.approx(r_b + r_c + r_d)
    assert got["decode_bytes"] == pytest.approx(sum(x[1] for x in dec))
    assert got["decode_attn_flops"] == pytest.approx(sum(x[2] for x in dec))
    # a prefix hit counted outside the wrapped plans: no work
    eng.stats["prefix_hit_pages"] += 1
    t._snapshot()
    t.ends = [t.ends[0], t.ends[-1]]
    assert t.work(chunk, page)["flops"] is None
