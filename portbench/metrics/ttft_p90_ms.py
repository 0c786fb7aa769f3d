"""ttft_p90_ms: the 90th percentile (nearest rank) over every request sent
in the window of the time from its submit to its first token reaching the
client. A request that failed or never had a first token counts as
missing (infinitely late)."""

import math

from portbench.lib.stats import percentile


def read(run: dict):
    t0, t1 = run["t0"], run["t_end"]
    ttft = [(r["times"][0] - r["submit"]) * 1e3
            if r["times"] and r["error"] is None else math.inf
            for r in run["requests"] if t0 <= r["submit"] < t1]
    ttft += [math.inf] * run.get("unfinished", 0)
    p = percentile(ttft, 90)
    return p if p is not None and math.isfinite(p) else None
