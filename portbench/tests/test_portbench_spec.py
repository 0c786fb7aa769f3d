"""BENCHMARK.json against the benchmark's contract, the harness's files
found by name, and no JAX anywhere in what the benchmark runs."""

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.lib import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()
BLOCKED = {"jax", "jaxlib", "flax", "v2pe_tpu"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check of 24 cells fits its time
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e and group in ("configs", "workloads",
                                          "per_layer"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert len(spec.metrics_for(BENCH, w["name"], False)) >= 2
        assert spec.metrics_for(BENCH, w["name"], True)


def test_every_moves_target_is_reported_by_the_same_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        where = set(m.get("workloads", cells))
        assert where <= set(target.get("workloads", cells)), m["name"]
        assert where <= cells
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_each_piece_is_a_file_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(REPO, c["file"]))
        conf = json.load(open(os.path.join(REPO, c["file"])))
        assert os.path.exists(os.path.join(
            HERE, "reference", f"{conf['reference']}.py"))
        assert conf["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.resolve(BENCH, w["name"])
        assert os.path.exists(os.path.join(
            HERE, "drivers", f"{cell['traffic']['driver']}.py"))
        assert cell["limits"], w["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(spec.load_module("metrics", m["name"]), "read")


def test_a_new_metric_is_a_new_file_and_an_entry(tmp_path):
    """In a copy of the benchmark, a metric added as one new file and one
    entry is found and read; no file that was there changes."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in glob.glob(
        str(tmp_path / "portbench" / "**" / "*"), recursive=True)
        if os.path.isfile(p)}
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({
        "name": "requests_sent.serve", "unit": "requests", "better":
        "higher", "source": "host_clock", "layer": "engine (serve/engine.py)",
        "moves": "serve_tok_s", "workloads": ["serve.2b.mmdoc"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "requests_sent.serve.py"
     ).write_text("def read(run):\n    return float(len(run['requests']))\n")
    loaded = spec.load_benchmark(str(tmp_path / "BENCHMARK.json"))
    names = [m["name"] for m in spec.metrics_for(loaded, "serve.2b.mmdoc",
                                                 True)]
    assert "requests_sent.serve" in names
    assert "requests_sent.serve" not in [
        m["name"] for m in spec.metrics_for(loaded, "serve.8b.docqa", True)]
    read = spec.load_module("metrics", "requests_sent.serve",
                            root=str(tmp_path / "portbench")).read
    assert read({"requests": [1, 2, 3]}) == 3.0
    for p, data in before.items():
        assert open(p, "rb").read() == data


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_source_imports_jax_and_the_reference_nothing_of_the_port():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & BLOCKED, (path, tops & BLOCKED)
        if os.sep + "reference" + os.sep in path:
            assert "v2pe_tpu_torch" not in tops, path
        if os.sep + "tests" + os.sep not in path:
            src = open(path).read()
            assert not re.search(r"\bbench\.py|(?<![A-Z])BENCH_\w*\.json",
                                 src), path


def test_what_a_run_loads_holds_no_jax():
    """Every module of the harness, the port's serving path and the
    reference imported in one process with JAX and the JAX package
    refused by name (top-level names whole: v2pe_tpu_torch passes)."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {sorted(BLOCKED)!r}:
            raise ImportError('refused ' + name)
sys.meta_path.insert(0, Refuse())
import glob, os
from portbench.lib import spec, device, program
from portbench.drivers import serve
from portbench.reference import internvl
import portbench.run, portbench.calibrate
program.load()
for p in glob.glob(os.path.join({HERE!r}, 'metrics', '*.py')):
    spec.load_module('metrics', os.path.basename(p)[:-3])
print(device.jax_loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_jax_check_compares_whole_names():
    from portbench.lib import device

    assert device.jax_loaded(["v2pe_tpu_torch", "v2pe_tpu_torch.ops",
                              "jaxtyping", "flaxen"]) == []
    assert device.jax_loaded(["v2pe_tpu.models", "jax", "jaxlib.xla",
                              "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                 "v2pe_tpu"]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "serve.2b.mmdoc",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
