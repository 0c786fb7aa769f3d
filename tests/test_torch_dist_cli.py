"""The port's train CLI as two processes on the CPU (gloo), launched as a
user launches it: the ``V2PE_*`` variables, ``--platform cpu``."""

from __future__ import annotations

import json
import pickle
import sys

import numpy as np

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import toy_dataset  # noqa: F401
from .torch_dist import spawn, wait


def test_train_cli_as_two_processes_on_fsdp2(toy_dataset, tmp_path):  # noqa
    """``python -m v2pe_tpu_torch.train.cli --platform cpu --mesh_fsdp 2``
    under the V2PE_* variables: both ranks exit 0 after 2 steps, rank 0
    alone logs the one loss, and one checkpoint holds both ranks' data
    states (written asynchronously, committed by rank 0)."""
    tok = tmp_path / "tok"
    _toy_tokenizer().save_pretrained(str(tok))
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "v2pe_tpu_torch.train.cli",
            "--model_preset", "debug_tiny", "--tokenizer", str(tok),
            "--meta_path", toy_dataset, "--output_dir", str(out),
            "--max_steps", "2", "--save_steps", "2", "--log_steps", "2",
            "--max_packed_tokens", "512", "--max_tiles", "2",
            "--max_dynamic_patch", "1", "--warmup_steps", "0",
            "--learning_rate", "1e-4", "--dtype", "float32",
            "--platform", "cpu", "--mesh_fsdp", "2"]
    procs = spawn(argv, 2, tmp_path / "ranks")
    wait(procs, tmp_path / "ranks")
    logs = [(tmp_path / "ranks" / f"rank{i}.log").read_text()
            for i in range(2)]
    assert [log.count(" loss ") for log in logs] == [1, 0], logs[0][-2000:]
    with open(out / "metrics.jsonl") as f:
        (line,) = f.readlines()
    assert np.isfinite(json.loads(line)["loss"])
    steps = sorted(p.name for p in out.iterdir() if p.name.startswith("step"))
    assert steps == ["step_00000002"]
    files = sorted(p.name for p in (out / steps[0]).iterdir())
    assert {"data_state_p0.pkl", "data_state_p1.pkl", "params.pt",
            "meta.json"} <= set(files)
    with open(out / steps[0] / "meta.json") as f:
        assert json.load(f) == {"step": 2, "num_processes": 2}
    with open(out / steps[0] / "data_state_p1.pkl", "rb") as f:
        assert pickle.load(f)  # rank 1 packed its own shard of the data
