"""The serving driver: a closed loop of clients against the port's
continuous-batching engine, then the output check against the plain
reference.

Set-up (``setup_s``): the benchmark's weights on the device, the port's
model around them, its ``InferenceEngine`` as the mix configures it, the
bank of tiles, and the mix's warm-up requests run through the engine.
Then the engine runs on its own scheduler thread (``start()``, as the
port's HTTP worker runs it) and ``clients`` threads send requests through
``submit_chat`` for ``seconds``; each times its requests from the submit
to each token's arrival. When the window closes no client sends again,
and every request in flight is waited for.

With ``trace`` the device is traced over whole scheduler steps in the
middle of the window (``TRACE_SPAN``), switched on and off inside the
engine's public ``step``; the work of those steps is counted from the
requests themselves (see ``Tracer``).

The check: once the window has closed, the peak read and the program
freed, the reference runs over a sample of the finished requests, drawn
from the seed with the longest prompt among them (``check`` in the mix:
``served_tokens`` at least, ``max_requests`` at most). It compares the
prompt ids and V2PE positions exactly, the first token's logits
(``EngineRequest.first_logits``) against the reference's by the largest
difference over the largest reference logit, and every served token by
the gap its reference logit lies below the reference's best.

``run`` returns the run's record, which the metrics read: ``setup_s``;
``t0`` and ``t_end`` (the window on ``time.perf_counter``'s clock);
``requests``, each with ``submit``, ``times`` (every token's arrival),
``done``, ``error``, ``prompt`` (tokens) and ``new``; ``unfinished``,
``attempted`` and ``failed`` (requests sent in the window); ``stats`` (the
engine's counters over the window) and ``page_size``;
``memory_peak_bytes`` and ``window_peak_bytes``; ``checks`` (the compared
numbers). A traced run adds ``traced`` (``lib/trace.py:summarize`` of the
traced steps, the port's launch counts over them as ``launches``, and the
work they did: ``flops``, ``prefill_roof_s``, ``decode_bytes``,
``decode_attn_flops``, each None where it could not be counted).
"""

from __future__ import annotations

import gc
import math
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.lib import program, spec, traffic, weights, work
from portbench.lib import trace as tr
from portbench.lib.device import smi
from portbench.lib.tokenizer import CodePointTokenizer
from portbench.reference import rules

TRACE_SPAN = (0.3, 0.7)  # the traced share of the window
DRAIN_S = 240.0          # how long requests in flight may take to finish


class Record:
    """One request as its client saw it."""

    def __init__(self, req: traffic.Request):
        self.spec = req
        self.submit = 0.0
        self.times: List[float] = []
        self.done: Optional[float] = None
        self.error: Optional[str] = None
        self.engine_req = None


def _client(c: int, eng, mix, bank, go, stop_at, records, live, lock):
    go.wait()
    # the first requests spread over a share of the ramp (the mix's
    # ``stagger``), so that the loop does not start as one wave
    time.sleep(c * mix.mix.get("stagger", 0.0) * mix.mix["ramp_s"]
               / mix.clients)
    rnd = 0
    while True:
        px = None
        for j in range(mix.mix["questions_per_document"]):
            if time.perf_counter() >= stop_at[0]:
                return
            req = mix.request(c, rnd, j)
            if px is None:
                px = traffic.pixels(bank, req)
            rec = Record(req)
            rec.submit = time.perf_counter()
            try:
                r = eng.submit_chat(px, req.text, max_new_tokens=req.max_new,
                                    num_patches_list=req.tiles)
            except (ValueError, RuntimeError) as e:  # refused: a failure
                rec.error = repr(e)
                with lock:
                    records.append(rec)
                return
            rec.engine_req = r
            with lock:
                live[id(r)] = r
            finished = False
            while not finished:
                # a decode block hands over its tokens at once: take them
                # all at one wake-up
                got = [r.token_queue.get()]
                now = time.perf_counter()
                try:
                    while True:
                        got.append(r.token_queue.get_nowait())
                except queue.Empty:
                    pass
                finished = got[-1] is None  # the engine's last put
                rec.times += [now] * (len(got) - finished)
            rec.done = now
            if r.error is not None:
                rec.error = repr(r.error)
            with lock:
                live.pop(id(r), None)
                records.append(rec)
            if rec.error:
                return
        rnd += 1


class Tracer:
    """The traced run's view of the engine.

    The device is traced over whole scheduler steps: the engine's public
    ``step`` switches the trace on at the start of the first step after
    one host time and off at the end of the first step after another. At
    both ends every request the clients hold (``EngineRequest``: its
    ``ids``, ``pixel_values``, ``tokens``) is read, and the engine's
    ``stats``. A request with no token at the start and one at the end was
    admitted in the traced steps; every later token was decoded there.

    The engine keeps no count, per request, of the prompt tokens its
    prefix cache served. So its ``prefix_hit_pages`` counter is also read
    around each ``_plan_admission`` call; where those readings do not add
    up to the counter's change over the traced steps, the work is not
    counted, and the metrics that need it are left out. The private
    methods ``_plan_admission``, ``_admit`` and ``_run_decode_block`` are
    otherwise wrapped only for spans, which name the device's idle gaps;
    a method the engine no longer has loses its span."""

    SPANS = {"_plan_admission": "plan_admission", "_admit": "admit",
             "_run_decode_block": "decode_block"}

    def __init__(self, eng, sizes: work.Sizes, records, live, lock,
                 context_id: int, device: str):
        self.eng, self.sizes = eng, sizes
        self.records, self.live, self.lock = records, live, lock
        self.context_id = context_id
        self.spans = []       # (label, start_ns, end_ns)
        self.hits = {}        # request_id -> prefix pages its plans took
        self.start_at = self.stop_at = math.inf
        self.trace = tr.DeviceTrace(device)
        self.launches = None
        self.stop_s = 0.0
        self.state = "before"
        self.ends = []        # ({request_id: tokens}, prefix_hit_pages)
        self.reqs = {}        # request_id -> EngineRequest
        eng.step = self._step(eng.step)
        for name, label in self.SPANS.items():
            orig = getattr(eng, name, None)
            if orig is not None:
                setattr(eng, name, self._span(orig, label,
                                              name == "_plan_admission"))

    def _snapshot(self) -> None:
        with self.lock:
            reqs = list(self.live.values()) + [
                r.engine_req for r in self.records
                if r.engine_req is not None]
        for r in reqs:
            self.reqs[r.request_id] = r
        self.ends.append(({r.request_id: len(r.tokens) for r in reqs},
                          self.eng.stats.get("prefix_hit_pages", 0)))

    def _step(self, orig):
        def step():
            if self.state == "before" and time.perf_counter() >= \
                    self.start_at:
                self._snapshot()
                self.trace.start()
                self.launches = program.kernel_launches()
                self.state = "tracing"
            out = orig()
            if self.state == "tracing" and time.perf_counter() >= \
                    self.stop_at:
                t = time.perf_counter()
                self.trace.stop()
                self.stop_s = time.perf_counter() - t
                after = program.kernel_launches()
                self.launches = {k: after[k] - self.launches.get(k, 0)
                                 for k in after}
                self._snapshot()
                self.state = "done"
            return out
        return step

    def _span(self, orig, label: str, count_hits: bool):
        def wrapped(*a, **kw):
            h0 = self.eng.stats.get("prefix_hit_pages", 0)
            t0 = time.time_ns()
            out = orig(*a, **kw)
            self.spans.append((label, t0, time.time_ns()))
            if count_hits and a:
                rid = a[0].request_id
                self.hits[rid] = self.hits.get(rid, 0) + \
                    self.eng.stats.get("prefix_hit_pages", 0) - h0
            return out
        return wrapped

    def work(self, chunk: int, page_size: int) -> Dict[str, Optional[float]]:
        """The useful work of the traced steps, and its rooflines."""
        (first, h0), (last, h1) = self.ends
        flops = prefill_roof = dec_flops = dec_bytes = dec_attn = 0.0
        hits = 0
        for rid, after in last.items():
            before = first.get(rid, 0)
            if after <= before:
                continue
            r = self.reqs[rid]
            S = len(r.ids)
            if before == 0:  # admitted in the traced steps
                pages = self.hits.get(rid, 0)
                hits += pages
                cached = pages * page_size
                tiles = 0
                if r.pixel_values is not None:
                    n_img = int((np.asarray(r.ids[cached:])
                                 == self.context_id).sum())
                    tiles = -(-n_img // self.sizes.image_tokens)
                f, roof = self.sizes.prefill(S, cached, chunk, tiles)
                flops += f
                prefill_roof += roof
            # token k (1-based) is decoded over S + k - 1 keys
            for k in range(max(before, 1) + 1, after + 1):
                f, nb, fa = self.sizes.decode_token(S + k - 1)
                dec_flops += f
                dec_bytes += nb
                dec_attn += fa
        if hits != h1 - h0:  # a hit the plans' readings did not see
            return {"flops": None, "prefill_roof_s": None,
                    "decode_bytes": dec_bytes, "decode_attn_flops": dec_attn}
        return {"flops": flops + dec_flops, "prefill_roof_s": prefill_roof,
                "decode_bytes": dec_bytes, "decode_attn_flops": dec_attn}


def _sample(records: List[Record], seed: int, check: dict) -> List[Record]:
    """The finished requests the reference reads: the longest prompt, then
    others drawn from the seed until ``served_tokens`` served tokens or
    ``max_requests`` requests."""
    done = [r for r in records if r.error is None and r.done is not None
            and r.engine_req is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.engine_req.ids))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 3]).permutation(len(rest))
    out = [longest]
    served = len(longest.engine_req.tokens)
    for i in order:
        if served >= check["served_tokens"] or \
                len(out) >= check["max_requests"]:
            break
        out.append(rest[i])
        served += len(rest[i].engine_req.tokens)
    return out


def compare(cell: dict, seed: int, kept: list, bank: np.ndarray, device,
            control: bool = False) -> Dict[str, float]:
    """The reference over each kept request (spec, the program's ids and
    positions, served tokens, first logits): the numbers compared."""
    conf = cell["config"]
    model_d = conf["model"]
    ref_mod = spec.load_module("reference", conf["reference"])
    ref_mod.no_tf32()
    tok = CodePointTokenizer(model_d["llm"]["vocab_size"])
    ctx_id = tok.convert_tokens_to_ids("<IMG_CONTEXT>")
    img_tokens = work.Sizes(model_d).image_tokens
    W = weights.make(model_d, seed, device)
    ref = ref_mod.Reference(model_d, W.__getitem__, device)
    ctl = ref_mod.Reference(model_d, W.__getitem__, device, fp8=True) \
        if control else None
    out = {"prompt_mismatch": 0.0, "pos_err": 0.0, "gap": 0.0,
           "first_err": 0.0, "served_checked": 0.0}
    if control:
        out.update(control_gap=0.0, control_first_err=0.0)
    with torch.no_grad():
        for req, ids_p, pos_p, served, first in kept:
            text = rules.prompt_text(conf["template"], req.text, req.tiles,
                                     img_tokens)
            ids = np.asarray(tok.encode(text), np.int64)
            pos = rules.v2pe_positions(ids, ctx_id,
                                       model_d["rope_pos_id_stride"],
                                       img_tokens)
            if len(ids) != len(ids_p) or not np.array_equal(ids, ids_p):
                out["prompt_mismatch"] += 1
                continue
            out["pos_err"] = max(out["pos_err"], float(np.abs(
                pos - pos_p).max()))
            r = ref_mod.served_gaps(ref, ids, pos, ctx_id,
                                    traffic.pixels(bank, req), served, ctl)
            out["gap"] = max(out["gap"], float(r["gaps"].max()))
            scale = float(r["first"].abs().max())
            out["first_err"] = max(out["first_err"], float(
                (first - r["first"]).abs().max()) / scale)
            out["served_checked"] += len(served)
            if control:
                out["control_gap"] = max(out["control_gap"],
                                         float(r["control_gaps"].max()))
                out["control_first_err"] = max(
                    out["control_first_err"], float(
                        (r["control_first"] - r["first"]).abs().max()) / scale)
    del W, ref, ctl
    # a run with nothing to compare proves nothing
    out["unchecked"] = float(out["served_checked"] == 0)
    return out


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def run(cell: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        control: bool = False, log=tr.log) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    laps = [("start", time.perf_counter())]

    def lap(name: str) -> None:
        if device == "cuda":
            torch.cuda.synchronize()
        laps.append((name, time.perf_counter()))

    conf, mix_d = cell["config"], cell["traffic"]
    model_d = conf["model"]
    sizes = work.Sizes(model_d)
    cfg = program.vlm_config(model_d)
    tok = CodePointTokenizer(model_d["llm"]["vocab_size"])
    ctx_id = tok.convert_tokens_to_ids("<IMG_CONTEXT>")
    program.load()
    lap("port imports")
    params = weights.make(model_d, seed, device)
    lap("weights")
    model = program.build_model(cfg, params)
    eng = program.engine(model, cfg, tok, seed, mix_d["engine"])
    lap("engine")
    mix = traffic.Mix(mix_d, seed)
    bank = traffic.tile_bank(mix_d, seed, device,
                             model_d["vision"]["image_size"])
    lap("tiles")
    for req in mix.warmup():
        eng.submit_chat(traffic.pixels(bank, req), req.text,
                        max_new_tokens=req.max_new,
                        num_patches_list=req.tiles)
        eng.run_until_idle()
    if trace:
        tr.warm(device)
    lap("warm-up")
    records: List[Record] = []
    live, lock = {}, threading.Lock()
    tracer = Tracer(eng, sizes, records, live, lock, ctx_id, device) \
        if trace else None
    go, stop_at = threading.Event(), [math.inf]
    clients = [threading.Thread(
        target=_client, args=(c, eng, mix, bank, go, stop_at, records, live,
                              lock), daemon=True)
        for c in range(mix_d["clients"])]
    for t in clients:
        t.start()
    eng.start()
    t_ramp = time.perf_counter()
    # the loop fills before the window opens: its first wave (every client
    # at once) is set-up, not what a client meets in a steady state
    go.set()
    time.sleep(mix_d["ramp_s"] / 2)
    if device == "cuda":  # a reading beside the window, not in it
        log(f"portbench: nvidia-smi in the ramp: {smi()}")
    time.sleep(max(0.0, t_ramp + mix_d["ramp_s"] - time.perf_counter()))
    setup_peak = _peak(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stats0 = dict(eng.stats)
    t0 = time.perf_counter()
    laps.append(("ramp", t0))
    t_end = t0 + seconds
    if tracer is not None:
        tracer.start_at = t0 + TRACE_SPAN[0] * seconds
        tracer.stop_at = t0 + TRACE_SPAN[1] * seconds
    stop_at[0] = t_end
    log(f"portbench: {cell['name']} seed {seed}: "
        f"{sum(p.numel() for p in params.values()) / 1e9:.3f}B parameters;"
        f" set-up {t0 - t_start:.2f} s: imports "
        f"{laps[0][1] - t_start:.2f}, " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(laps, laps[1:]))
        + f" (kernel build {program.build_seconds():.1f} s)")
    time.sleep(max(0.0, t_end - time.perf_counter()))
    stats1 = dict(eng.stats)
    deadline = time.perf_counter() + DRAIN_S
    for t in clients:
        t.join(timeout=max(0.0, deadline - time.perf_counter()))
    stuck = sum(t.is_alive() for t in clients)
    window_peak = _peak(device)
    eng.stop()
    if device == "cuda":
        log(f"portbench: nvidia-smi after the window: {smi()}")
    if stuck:
        log(f"portbench: {stuck} clients still waiting after {DRAIN_S} s")
    with lock:
        recs = list(records)
    out = {
        "setup_s": t0 - t_start, "seconds": seconds, "t0": t0,
        "t_end": t_end,
        "requests": [{"submit": r.submit, "times": list(r.times),
                      "done": r.done, "error": r.error,
                      "prompt": (len(r.engine_req.ids) if r.engine_req
                                 is not None else 0),
                      "new": r.spec.max_new} for r in recs],
        "unfinished": stuck,
        "attempted": sum(r.submit >= t0 for r in recs) + stuck,
        "failed": sum(r.error is not None for r in recs) + stuck,
        "stats": {k: stats1.get(k, 0) - stats0.get(k, 0) for k in stats1},
        "page_size": eng.page_size,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "window_peak_bytes": window_peak,
    }
    if tracer is not None and tracer.state == "done":
        out["traced"] = _traced(tracer, eng)
    sample = _sample(recs, seed, mix_d["check"])
    kept = [(r.spec, np.asarray(r.engine_req.ids),
             np.asarray(r.engine_req.pos), list(r.engine_req.tokens),
             r.engine_req.first_logits.float().cpu()) for r in sample]
    # the program's state goes before the reference runs
    for r in recs:
        r.engine_req = None
    del eng, model, params, sample, records, recs, tracer, live
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = compare(cell, seed, kept, bank, device, control=control)
    sent = [r for r in out["requests"] if r["submit"] >= t0]
    # a client's gaps between two hand-overs of tokens: a decode block,
    # and whatever admissions the scheduler ran before it
    gaps = sorted(b - a for r in out["requests"] for a, b in
                  zip(sorted(set(r["times"])), sorted(set(r["times"]))[1:])
                  if t0 <= a < t_end)
    q = (np.percentile(gaps, [10, 50, 90]) if gaps else [math.nan] * 3)
    log(f"portbench: window: {len(sent)} requests sent, "
        f"{sum(r['done'] is not None and r['done'] < t_end for r in sent)} "
        f"completed in it; token hand-over gaps p10 / p50 / p90 "
        f"{q[0]:.3f} / {q[1]:.3f} / {q[2]:.3f} s; "
        f"{out['stats']}; reference over {len(kept)} "
        f"requests, {int(checks['served_checked'])} served tokens, in "
        f"{time.perf_counter() - t_ref:.1f} s; readings {checks}")
    out["checks"] = checks
    out["checked_requests"] = len(kept)
    return out


def _traced(tracer: Tracer, eng) -> dict:
    """The traced steps' summary, launches and work."""
    t = time.perf_counter()
    summary = tr.summarize(tracer.trace, tracer.spans)
    tr.log(f"portbench: trace of {summary['window_s']:.2f} s, "
           f"{summary['events']} device events; stopping it took "
           f"{tracer.stop_s:.2f} s on the scheduler thread, reading it "
           f"{time.perf_counter() - t:.2f} s")
    summary["launches"] = tracer.launches
    summary.update(tracer.work(eng.chunk_size, eng.page_size))
    return summary
