"""setup_s: seconds from the process's start to the window's first
request (loading, weights, the engine, warm-up; the kernels' build on a
checkout's first run)."""


def read(run: dict):
    return run["setup_s"]
