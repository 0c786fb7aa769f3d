"""The port's ``tools/`` counterparts against the repo's ``tools/`` on the
same inputs, on the CPU: ``token_count`` and ``test_image_patch`` print
the same lines on a small dataset made here (the toy tokenizer, images of
several shapes); ``inference_test --platform cpu`` on a tiny float32
checkpoint exported by the JAX package gives JAX's greedy answer."""

from __future__ import annotations

import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from v2pe_tpu.core.config import LLMConfig, VisionConfig, VLMConfig
from v2pe_tpu.models.export import export_torch_state_dict as jax_export
from v2pe_tpu.models.export import save_safetensors as jax_save
from v2pe_tpu.models.params import init_vlm_params as jax_init

from .test_data_pipeline import _toy_tokenizer

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two datasets of a meta file: images of five shapes (one sample with
    two), a text-only sample; the toy tokenizer saved beside them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("tools")
    _toy_tokenizer().save_pretrained(str(root / "tok"))
    rng = np.random.RandomState(0)
    sizes = [(64, 80), (900, 300), (448, 448), (1000, 1400), (30, 500)]
    for i, (w, h) in enumerate(sizes):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(root / f"im{i}.png")
    conv = [{"from": "human", "value": "<image>\nWhat is in the picture?"},
            {"from": "gpt", "value": "A cat sits on a mat in the sun."}]
    a = [{"image": "im0.png", "conversations": conv},
         {"image": ["im1.png", "im2.png"], "conversations": conv},
         {"conversations": [{"from": "human", "value": "Hello there."},
                            {"from": "gpt", "value": "Hi!"}]}]
    b = [{"image": "im3.png", "conversations": conv},
         {"image": "im4.png", "conversations": conv[:1]}]
    meta = {}
    for name, items in (("first", a), ("second", b)):
        with open(root / f"{name}.jsonl", "w") as f:
            for it in items:
                f.write(json.dumps(it) + "\n")
        meta[name] = {"root": str(root),
                      "annotation": str(root / f"{name}.jsonl")}
    (root / "meta.json").write_text(json.dumps(meta))
    return root


def _run_script(path, argv, capsys):
    """A script of the repo's ``tools/`` run as ``python tools/x.py``;
    what it printed."""
    old = sys.argv
    sys.argv = [str(path)] + argv
    try:
        capsys.readouterr()
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--grid"],
                                   ["--num-image-token", "64", "--limit",
                                    "1", "--max-num", "4"]])
def test_token_count_prints_what_the_jax_tool_prints(dataset, capsys,
                                                     extra):
    from v2pe_tpu_torch.tools import token_count

    argv = ["--meta", str(dataset / "meta.json"), "--tokenizer",
            str(dataset / "tok"), "--workers", "2", *extra]
    want = _run_script(REPO / "tools" / "token_count.py", argv, capsys)
    token_count.main(argv)
    got = capsys.readouterr().out
    assert got == want and "[second] samples=" in got


@pytest.mark.parametrize("extra", [[], ["--max-num", "3", "--limit", "1"]])
def test_image_patch_prints_what_the_jax_tool_prints(dataset, capsys,
                                                     extra):
    from v2pe_tpu_torch.tools import test_image_patch

    argv = ["--meta", str(dataset / "meta.json"), *extra]
    want = _run_script(REPO / "tools" / "test_image_patch.py", argv, capsys)
    test_image_patch.main(argv)
    got = capsys.readouterr().out
    assert got == want and "tiles:" in got


def test_inference_test_on_the_cpu_gives_jax_greedy_answer(dataset, capsys,
                                                           tmp_path):
    """A tiny float32 checkpoint the JAX package exported; the same image
    and question through both tools: the same answer."""
    from v2pe_tpu.data.constants import SPECIAL_TOKENS

    from v2pe_tpu_torch.tools import inference_test

    tok = _toy_tokenizer()
    tok.add_tokens(list(SPECIAL_TOKENS), special_tokens=True)
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    jax_save(jax_export(jax_init(jax.random.PRNGKey(7), cfg), cfg),
             str(ckpt / "model.safetensors"), dtype="float32")
    (ckpt / "config.json").write_text(cfg.to_json())
    argv = ["--checkpoint", str(ckpt), "--tokenizer", str(dataset / "tok"),
            "--image", str(dataset / "im1.png"), "--question",
            "<image>\nWhat is it?", "--max-num", "4", "--max-new-tokens",
            "8"]
    out = _run_script(REPO / "tools" / "inference_test.py", argv, capsys)
    want = out.split("Assistant: ", 1)[1].rstrip("\n")
    got = inference_test.main(argv + ["--platform", "cpu"])
    assert got == want and len(got) > 0
    assert capsys.readouterr().out.endswith(f"Assistant: {want}\n")


# ---------------------------------------------------------- the scripts


# launcher -> (its flags on 8 cards, None for a switch; the preset)
LAUNCHERS = {
    "train_2b_v2pe_32k.sh": ({"--mesh_fsdp": "8", "--grad_accum_steps":
                              "128", "--max_packed_tokens": "34000"},
                             "internvl2_2b"),
    "train_2b_v2pe_256k_ring.sh": ({"--mesh_fsdp": "1", "--mesh_seq": "8",
                                    "--use_8bit_optimizer": None,
                                    "--ring_mode": "scan"}, "internvl2_2b"),
    "train_8b_v2pe_128k_stage1.sh": ({"--mesh_fsdp": "2", "--mesh_seq":
                                      "4"}, "internvl2_5_8b"),
}


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_launchers_run_the_train_cli_under_torchrun(tmp_path, name):
    """Each launcher on a host of 8 cards (a stand-in ``torchrun`` that
    records its arguments): one process a card, the port's train CLI, the
    recipe's mesh and flags."""
    import os
    import subprocess

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "torchrun"
    fake.write_text('#!/usr/bin/env bash\nprintf "%s\\n" "$@" > '
                    f'"{tmp_path}/args"\n')
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", GPUS="8",
               OUTPUT_DIR=str(tmp_path / "out"))
    subprocess.run(["bash", str(REPO / "v2pe_tpu_torch" / "scripts" / name),
                    "--max_steps", "3"], env=env, check=True,
                   capture_output=True)
    args = (tmp_path / "args").read_text().split("\n")
    assert args[:4] == ["--nnodes", "1", "--nproc_per_node", "8"]
    assert args[args.index("-m") + 1] == "v2pe_tpu_torch.train.cli"
    want, preset = LAUNCHERS[name]
    pairs = list(zip(args, args[1:]))
    for flag, value in want.items():
        assert (flag, value) in pairs if value else flag in args, flag
    for flag, value in (("--model_preset", preset),
                        ("--rope_pos_id_version", "v2pe_rnd"),
                        ("--loss_reduction", "square"),
                        ("--max_steps", "3")):
        assert (flag, value) in pairs, flag


def test_bench_scripts_run_on_the_cpu_when_asked(capsys):
    """``bench_decode`` and ``bench_train_remat`` on a tiny preset: one
    line a metric, each naming where it ran (one thread: the suite's
    other workers share the cores)."""
    import torch

    from v2pe_tpu_torch.scripts import bench_decode, bench_train_remat

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        lines = bench_decode.main([
            "--model-preset", "debug_tiny", "--platform", "cpu",
            "--seq-len", "512", "--tiles", "1", "--decode-tokens", "2",
            "--repeats", "1"])
        assert [x["metric"] for x in lines] == ["ttft_0k_1tiles_dense_ms",
                                                "decode_tok_s_0k_dense"]
        assert all(x["value"] > 0 and x["card"] == "cpu" for x in lines)
        lines = bench_train_remat.main([
            "--model-preset", "debug_tiny", "--platform", "cpu",
            "--tokens", "512", "--tiles", "1", "--long-tokens", "768",
            "--long-tiles", "1", "--steps", "1", "--policies",
            "attn_saved"])
    finally:
        torch.set_num_threads(threads)
    assert [x["remat"] for x in lines] == ["attn_saved", "full"]
    assert [x["metric"] for x in lines] == [
        "train_tok_s_0k_1tiles_attn_saved", "train_tok_s_0k_1tiles_full"]
    assert all(x["value"] > 0 and np.isfinite(x["loss"]) for x in lines)
    assert len(capsys.readouterr().out.splitlines()) == 4
