"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

A cell names a configuration (its file is the ``file`` of the config
entry) and a traffic mix (``traffic/<name>.json``). The mix names its
driver (``drivers/<driver>.py``) and the configuration names its plain
reference (``reference/<reference>.py``). Each metric is read by
``metrics/<metric name>.py``. So a new cell, mix, driver or metric is a
new file plus an entry, and no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def load_benchmark(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: str = REPO) -> dict:
    """The cell ``workload``: its entry, its configuration's entry and file,
    its traffic mix and the limits its output check holds to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    bench_dir = os.path.join(root, "portbench")
    limits = os.path.join(bench_dir, "limits", f"{workload}.json")
    return {
        "name": workload,
        "chips": int(cell["chips"]),
        "entry": cell,
        "config": _json(os.path.join(root, entry["file"])),
        "traffic": _json(os.path.join(bench_dir, "traffic",
                                      f"{cell['traffic']}.json")),
        "limits": _json(limits) if os.path.exists(limits) else {},
    }


def load_module(kind: str, name: str, root: str = HERE) -> ModuleType:
    """``<root>/<kind>/<name>.py`` as a module (a metric's name may hold a
    dot, so the file is loaded by its path, not imported by name)."""
    path = os.path.join(root, kind, f"{name}.py")
    mod_name = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` off) or its per-layer
    metrics (``trace`` on), in the order ``BENCHMARK.json`` lists them."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if _applies(m, workload)]
