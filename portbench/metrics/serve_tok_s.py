"""serve_tok_s: the prompt tokens of every request whose first token
arrived in the window (those served from the prefix cache included), and
every generated token that arrived in it, over the window's seconds."""


def read(run: dict):
    t0, t1 = run["t0"], run["t_end"]
    n = 0
    for r in run["requests"]:
        times = r["times"]
        if times and t0 <= times[0] < t1:
            n += r["prompt"]
        n += sum(1 for t in times if t0 <= t < t1)
    return n / (t1 - t0) if n else None
