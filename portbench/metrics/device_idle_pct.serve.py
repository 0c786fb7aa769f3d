"""device_idle_pct.serve: 100 x (1 - the union of the device's activity /
the traced steps' wall time)."""


def read(run: dict):
    t = run.get("traced")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
