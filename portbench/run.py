"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic mix, driver and metrics are found by the
names ``BENCHMARK.json`` gives (``portbench/lib/spec.py``). The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the output check compared,
with its limit. The same numbers end standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def judge(checks: dict, limits: dict) -> tuple:
    """(correct, [name, value, limit]) over the numbers that have a limit;
    a number without one, or a limit without its number, is not
    correct."""
    rows = [[k, checks.get(k), v] for k, v in limits.items()]
    ok = bool(rows) and all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.lib import device, spec
    from portbench.lib import trace as tr

    bench = spec.load_benchmark()
    cell = spec.resolve(bench, args.workload)
    device.require_cards(cell["chips"])
    tr.log(f"portbench: {args.workload} seed {args.seed} "
           f"{args.seconds:g} s trace {args.trace}; card: {device.smi()}")
    driver = spec.load_module("drivers", cell["traffic"]["driver"])
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     t_start=T_START)

    metrics = {}
    for m in spec.metrics_for(bench, args.workload, bool(args.trace)):
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    checks = dict(run["checks"])
    checks["failed"] = float(run["failed"])
    correct, rows = judge(checks, cell["limits"])
    found = device.jax_loaded()
    if found:
        tr.log(f"portbench: refused: JAX or the JAX package is loaded "
               f"({', '.join(found)})")
        return 3
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics,
              "device": device.info(cell["chips"], run["memory_peak_bytes"])}
    if args.trace and "traced" in run:
        result["device"]["busy_s"] = run["traced"]["busy_s"]
        result["device"]["window_s"] = run["traced"]["window_s"]
        result["breakdown"] = tr.breakdown(run["traced"])
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        tr.log(f"check {k}: {v} (limit {lim})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
