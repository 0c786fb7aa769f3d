"""prefix_hit_pct.serve: 100 x the prompt tokens the prefix cache served
over the prompt tokens of the requests admitted in the window. The served
tokens are the engine's own counter, ``prefix_hit_pages``, over the window
times its page size; the admitted requests are those whose first token
reached their client in the window."""


def read(run: dict):
    t0, t1 = run["t0"], run["t_end"]
    prompt = sum(r["prompt"] for r in run["requests"]
                 if r["times"] and t0 <= r["times"][0] < t1)
    if not prompt:
        return None
    hits = run["stats"].get("prefix_hit_pages", 0) * run["page_size"]
    return 100.0 * hits / prompt
