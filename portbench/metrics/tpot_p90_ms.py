"""tpot_p90_ms: the 90th percentile (nearest rank), over the requests
completed in the window, of (last token's time - first token's time) /
(tokens - 1), as the client saw them."""

from portbench.lib.stats import percentile


def read(run: dict):
    t0, t1 = run["t0"], run["t_end"]
    per = [(r["times"][-1] - r["times"][0]) * 1e3 / (len(r["times"]) - 1)
           for r in run["requests"]
           if r["error"] is None and len(r["times"]) > 1
           and r["done"] is not None and t0 <= r["done"] < t1]
    return percentile(per, 90)
