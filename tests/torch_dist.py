"""Launch a multi-process run of the port on the CPU (gloo) from a test.

Each rank is ``python -m tests.torch_dist_worker SPEC`` with the
``V2PE_*`` launcher variables and a ``file://`` rendezvous under the
test's temporary directory (no TCP port to race for under xdist). Every
rank has its own time limit: a hung collective kills the run and fails the
test instead of holding the suite."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def spawn(argv, world: int, workdir: Path, extra_env=None):
    """Start ``world`` processes of ``argv`` (a list, run from the repo
    root) as the ranks of one process group; returns them."""
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / "store"
    if store.exists():
        store.unlink()
    procs = []
    for rank in range(world):
        env = dict(os.environ, V2PE_NUM_PROCESSES=str(world),
                   V2PE_PROCESS_ID=str(rank),
                   V2PE_COORDINATOR=f"file://{store}",
                   OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(REPO), **(extra_env or {}))
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    return procs


def wait(procs, workdir: Path, timeout: float = TIMEOUT_S) -> None:
    """Wait for every rank; on a failure or the time limit kill them all
    and raise with the ranks' logs."""
    deadline = time.time() + timeout
    failed = None
    for p in procs:
        try:
            rc = p.wait(timeout=max(deadline - time.time(), 0.1))
        except subprocess.TimeoutExpired:
            failed = f"timed out after {timeout:.0f} s"
            break
        if rc != 0:
            failed = f"a rank exited with {rc}"
            break
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        logs = "\n".join(
            f"--- rank {i}\n" + (workdir / f"rank{i}.log").read_text()[-4000:]
            for i in range(len(procs)))
        raise AssertionError(f"multi-process run {failed}\n{logs}")


class Run:
    """A started worker run; :meth:`result` waits for it."""

    def __init__(self, spec: dict, world: int, workdir: Path):
        workdir.mkdir(parents=True, exist_ok=True)
        self.workdir = workdir
        self.path = workdir / "spec.pkl"
        with open(self.path, "wb") as f:
            pickle.dump(spec, f)
        self.procs = spawn([sys.executable, "-m", "tests.torch_dist_worker",
                            str(self.path)], world, workdir)
        self._out = None

    def result(self) -> list:
        if self._out is None:
            wait(self.procs, self.workdir)
            with open(str(self.path) + ".out", "rb") as f:
                self._out = pickle.load(f)
        return self._out


def np_tree(tree):
    """A JAX parameter tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)
