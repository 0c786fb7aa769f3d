"""Read the numbers a cell's output check compares, over many seeds in one
process, and the control's beside them on some: the readings its limits
are set from (``portbench/limits/<cell>.json``).

    python3 portbench/calibrate.py --workload serve.2b.mmdoc \
        --seeds 11,12,13 --control 11,12,13 --seconds 15 \
        --out chiprun_out/calibrate.jsonl

Each seed is a whole run of the cell's driver at its own load, with a
short window, and no metric; with a seed in ``--control`` the plain
reference also runs as the control (float8 products, the precision below
the configuration's bfloat16) over the same requests and tokens. One JSON
line a seed goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from portbench.lib import device, spec

    bench = spec.load_benchmark()
    cell = spec.resolve(bench, args.workload)
    device.require_cards(cell["chips"])
    driver = spec.load_module("drivers", cell["traffic"]["driver"])
    control = {int(s) for s in args.control.split(",") if s}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for s in args.seeds.split(","):
        seed = int(s)
        t = time.perf_counter()
        run = driver.run(cell, seed, args.seconds, False,
                         control=seed in control)
        line = {"workload": args.workload, "seed": seed,
                "control": seed in control, "checks": run["checks"],
                "attempted": run["attempted"], "failed": run["failed"],
                "setup_s": run["setup_s"],
                "seconds": time.perf_counter() - t, "card": device.smi()}
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
