"""The serving driver for a model whose decoder is the DeepSeek-V3 block
(latent attention and experts): ``drivers/serve.py``'s own ``run``, in a
module instance of its own (``spec.load_module`` loads a fresh one), given
this architecture's weights (``lib/weights_mla_moe.py``), work counts
(``lib/work_mla_moe.py``), launch counters and output check. Everything
else (the clients, the window, the trace and the record ``run`` returns)
is ``serve.py``'s.

The launch counters a traced run reads at its two ends add kernel #12's
(``ops/mla_attention.LAUNCHES``: ``mla_decode``, ``mla_chunk``) and the
engine's expert counters (``moe_assignments``, ``moe_experts_hit``,
``moe_max_load``: ``InferenceEngine.stats``, which each harvest brings up
to date, so at a scheduler step's end they hold every step before it), and
the traced record gains the expert products' roofline seconds.

The output check is ``serve.py``'s, aware of routing. On random weights
a near-tied expert choice is decided by rounding, so the bf16 program and
the float32 reference choose apart at some compared positions, and those
logits then move by far more than the precision does. The engine records
the experts each served token was produced with (``record_routes``,
``EngineRequest.routes``); the reference takes them at those positions
(``reference/kimi_vl.py:served_gaps``) and holds them to its own scores:
``route_err``, the largest amount by which a chosen expert's score plus
bias lies below the reference's k-th best. ``unrouted`` counts compared
requests whose choices were not all recorded."""

from __future__ import annotations

import types
import weakref
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import program, spec, traffic, weights_mla_moe, \
    work_mla_moe
from portbench.lib.tokenizer import CodePointTokenizer
from portbench.reference import rules

MOE = ("moe_assignments", "moe_experts_hit", "moe_max_load")


def _program() -> types.ModuleType:
    """``lib/program.py`` with the engine it builds recording each served
    token's experts and kept, and its launch counters widened."""
    shim = types.ModuleType("portbench_program_mla_moe")
    shim.__dict__.update({k: v for k, v in vars(program).items()
                          if not k.startswith("__")})
    built = []   # a weak reference: the run frees the engine before its check

    def engine(*a, **kw):
        eng = program.engine(*a, **kw)
        eng.record_routes = True
        built.append(weakref.ref(eng))
        return eng

    def kernel_launches():
        from v2pe_tpu_torch.ops import mla_attention

        out = program.kernel_launches()
        out.update(mla_attention.LAUNCHES)
        eng = built[-1]() if built else None
        if eng is not None:
            out.update({k: eng.stats.get(k, 0) for k in MOE})
        return out

    shim.engine, shim.kernel_launches = engine, kernel_launches
    return shim


def compare(cell: dict, seed: int, kept: list, bank: np.ndarray, device,
            control: bool = False, routes: List = ()) -> Dict[str, float]:
    """``serve.compare`` with the program's expert choices (``routes``, one
    array (served tokens, MoE layers, k) for each kept request) taken by
    the reference at the compared positions: the numbers compared."""
    conf = cell["config"]
    model_d = conf["model"]
    ref_mod = spec.load_module("reference", conf["reference"])
    ref_mod.no_tf32()
    tok = CodePointTokenizer(model_d["llm"]["vocab_size"])
    ctx_id = tok.convert_tokens_to_ids("<IMG_CONTEXT>")
    img_tokens = work_mla_moe.Sizes(model_d).image_tokens
    W = weights_mla_moe.make(model_d, seed, device)
    ref = ref_mod.Reference(model_d, W.__getitem__, device)
    ctl = ref_mod.Reference(model_d, W.__getitem__, device, fp8=True) \
        if control else None
    out = {"prompt_mismatch": 0.0, "pos_err": 0.0, "gap": 0.0,
           "first_err": 0.0, "route_err": 0.0, "unrouted": 0.0,
           "served_checked": 0.0}
    if control:
        out.update(control_gap=0.0, control_first_err=0.0,
                   control_route_err=0.0)
    with torch.no_grad():
        for (req, ids_p, pos_p, served, first), chosen in zip(kept, routes):
            text = rules.prompt_text(conf["template"], req.text, req.tiles,
                                     img_tokens)
            ids = np.asarray(tok.encode(text), np.int64)
            pos = rules.v2pe_positions(ids, ctx_id,
                                       model_d["rope_pos_id_stride"],
                                       img_tokens)
            if len(ids) != len(ids_p) or not np.array_equal(ids, ids_p):
                out["prompt_mismatch"] += 1
                continue
            if len(chosen) != len(served):
                out["unrouted"] += 1
                continue
            out["pos_err"] = max(out["pos_err"], float(np.abs(
                pos - pos_p).max()))
            r = ref_mod.served_gaps(ref, ids, pos, ctx_id,
                                    traffic.pixels(bank, req), served, ctl,
                                    routes=chosen)
            out["gap"] = max(out["gap"], float(r["gaps"].max()))
            scale = float(r["first"].abs().max())
            out["first_err"] = max(out["first_err"], float(
                (first - r["first"]).abs().max()) / scale)
            out["route_err"] = max(out["route_err"], r["route_err"])
            out["served_checked"] += len(served)
            if control:
                out["control_gap"] = max(out["control_gap"],
                                         float(r["control_gaps"].max()))
                out["control_first_err"] = max(
                    out["control_first_err"], float(
                        (r["control_first"] - r["first"]).abs().max()) / scale)
                out["control_route_err"] = max(out["control_route_err"],
                                               r["control_route_err"])
    del W, ref, ctl
    # a run with nothing to compare proves nothing
    out["unchecked"] = float(out["served_checked"] == 0)
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, **kw) -> dict:
    """``serve.run``; a traced record adds ``expert_roof_s``, the roofline
    seconds of the traced steps' expert products (None without the
    engine's expert counters)."""
    serve = spec.load_module("drivers", "serve")
    serve.weights, serve.work, serve.program = \
        weights_mla_moe, work_mla_moe, _program()
    sample, routes = serve._sample, []

    def sampled(records, seed, check):
        """``serve._sample``, keeping the sampled requests' recorded
        experts, in the order the check reads them."""
        out = sample(records, seed, check)
        routes[:] = [np.asarray(r.engine_req.routes) for r in out]
        return out

    def checked(*a, **kw):
        return compare(*a, routes=list(routes), **kw)

    serve._sample, serve.compare = sampled, checked
    out = serve.run(cell, seed, seconds, trace, **kw)
    t = out.get("traced")
    if t is not None:
        n = t["launches"]
        t["expert_roof_s"] = work_mla_moe.Sizes(
            cell["config"]["model"]).expert_roof_s(
                n["moe_assignments"], n["moe_experts_hit"]) \
            if n.get("moe_assignments") else None
    return out
