"""The port's train CLI as two processes on the CPU (gloo) with int8 Adam
over sharded leaves, LoRA, compress-seq and two pipe stages (apart from
``tests/test_torch_dist_cli.py`` to keep each file near 50 s on one
worker)."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import toy_dataset  # noqa: F401
from .torch_dist import spawn, wait

RECIPES = {
    # the bench recipe's optimizer over sharded leaves
    "int8_fsdp2": ["--mesh_fsdp", "2", "--use_8bit_optimizer"],
    "lora_fsdp2": ["--mesh_fsdp", "2", "--use_llm_lora", "4",
                   "--use_backbone_lora", "2"],
    "compress_tensor2": ["--mesh_tensor", "2", "--compress_seq",
                         "--fuse_method", "cross-attn", "--chunk_num", "4"],
    # two GPipe stages, a layer each, two microbatches of a row
    "int8_pipe2": ["--mesh_pipe", "2", "--pipe_microbatches", "2",
                   "--rows_per_batch", "2", "--max_tiles", "4",
                   "--use_8bit_optimizer",
                   "--dist_backend", "gloo"],
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_cli_recipes_on_a_mesh(toy_dataset, tmp_path,  # noqa: F811
                                     recipe):
    """int8 Adam, LoRA and compress-seq through the CLI as two processes:
    both ranks exit 0 after 2 steps; the checkpoint holds one device's
    state (int8 codes of whole leaves; the adapters whole with their
    alpha; the compress parameters whole)."""
    import torch

    tok = tmp_path / "tok"
    _toy_tokenizer().save_pretrained(str(tok))
    out = tmp_path / "out"
    argv = [sys.executable, "-m", "v2pe_tpu_torch.train.cli",
            "--model_preset", "debug_tiny", "--tokenizer", str(tok),
            "--meta_path", toy_dataset, "--output_dir", str(out),
            "--max_steps", "2", "--save_steps", "2", "--log_steps", "1",
            "--max_packed_tokens", "512", "--max_tiles", "2",
            "--max_dynamic_patch", "1", "--warmup_steps", "0",
            "--learning_rate", "1e-4", "--dtype", "float32",
            "--platform", "cpu"] + RECIPES[recipe]
    procs = spawn(argv, 2, tmp_path / "ranks")
    wait(procs, tmp_path / "ranks")
    with open(out / "metrics.jsonl") as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f)
    step = out / "step_00000002"
    params = torch.load(step / "params.pt")
    opt = torch.load(step / "opt_state.pt")
    if recipe.startswith("int8"):
        mom = opt["moments"]["llm/output_kernel"]
        assert mom["m_code"].numel() == params[
            "llm.output.weight"].numel() == 92553 * 64
    if recipe.endswith("pipe2"):  # both stages' layers, whole leaves
        assert {"llm.layers.0.wqkv.weight", "llm.layers.1.wqkv.weight"} \
            <= set(params)
        assert opt["moments"]["llm/layers/wqkv_kernel"]["m_code"].numel() \
            == 2 * 64 * 128
    if recipe.startswith("lora"):
        assert params["llm.layers.1.wqkv.A"].shape == (4, 64)
        assert float(params["vision.layers.0.qkv.alpha"]) == 4.0
    if recipe.startswith("compress"):
        assert params["compress.fuse.0.wq.weight"].shape == (64, 64)
        assert params["llm.layers.0.wqkv.weight"].shape == (128, 64)
