"""Compress-seq on a mesh of processes (gloo on the CPU) against JAX's
single-process compress step on the combined batch: fsdp 2 x tensor 2 in
4 processes, both fuse methods ('add'; 'cross-attn', whose fuse splits its
heads over ``tensor``), on the 8/4-head model of
``tests/test_torch_dist_tensor.py`` in 4 chunks of 64 tokens.

Each decoder layer's part of the compress forward runs through the
layer's call (FSDP2 gathers its weights and reduce-scatters their
gradients); the interaction and fuse attentions split their heads over
``tensor``. fp32: loss and grad norm within 1e-5 relative, every parameter
after two steps within 2e-5. A sharded sequence stays refused: JAX's
trainer hands its compress step the zigzag-permuted batch under ``seq``
(ROADMAP Queue 3); ``tests/torch_compress_seq_probe.py`` shows it.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from v2pe_tpu.models.compress_seq import init_compress_params
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import synth as jsynth

from .test_torch_dist_mesh import (TC, check_against_jax, global_batches,
                                   jax_reference)
from .test_torch_dist_tensor import cfg_4kv
from .torch_dist import Run, np_tree
from .torch_parity import port_config

MESH = dict(fsdp=2, tensor=2)
FUSES = ("add", "cross-attn")


def compress_cfg(fuse):
    return dataclasses.replace(cfg_4kv(), compress_seq=True,
                               fuse_method=fuse, chunk_num=4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfgs = {f: compress_cfg(f) for f in FUSES}
    trees = {}
    for f, cfg in cfgs.items():
        tree = jax_init(jax.random.PRNGKey(0), cfg)
        tree["compress"] = init_compress_params(tree["llm"], cfg=cfg.llm,
                                                fuse_method=f)
        trees[f] = np_tree(tree)
    batches = global_batches(cfgs["add"])
    spec = dict(cfg=port_config(cfgs["add"]).to_json(), tree=trees["add"],
                batches=batches, img_context_id=jsynth.IMG_CONTEXT_ID)
    tasks = [dict(kind="train", mesh=MESH, tc=TC,
                  cfg=port_config(cfgs[f]).to_json(), tree=trees[f])
             for f in FUSES]
    run = Run(dict(spec, tasks=tasks), 4, tmp_path_factory.mktemp("comp"))
    want = {f: jax_reference(cfgs[f], trees[f], batches, TC) for f in FUSES}
    return run, want


@pytest.mark.parametrize("fuse", FUSES)
def test_compress_steps_on_fsdp2_tensor2_match_jax(runs, fuse):
    """Two compress-seq steps at fsdp 2 x tensor 2 equal JAX's two
    single-process steps on the combined batch; the interaction and fuse
    attentions split over ``tensor``."""
    run, want = runs
    got = run.result()[FUSES.index(fuse)]
    assert {"compress.interaction.0.wqkv.weight",
            "compress.interaction.1.wo.weight"} <= set(got["rules"])
    if fuse == "cross-attn":
        assert {"compress.fuse.0.wq.weight", "compress.fuse.0.wkv.weight",
                "compress.fuse.1.wo.weight"} <= set(got["rules"])
    assert "compress.layer_scale" not in got["rules"]
    check_against_jax(got, want[fuse])


@pytest.mark.parametrize("flags,item", [
    (["--mesh_pipe", "2"], "Queue 1 item 8"),
    (["--pipe_microbatches", "2"], "Queue 1 item 8"),
    (["--compress_seq", "--mesh_seq", "2"], "Queue 1 item 6.4"),
    (["--offload_optimizer"], "'Left out of the port'"),
])
def test_what_stays_refused_names_its_roadmap_item(flags, item):
    """The train CLI's refusals, before it reads anything: each names its
    ROADMAP item. int8 Adam on fsdp / tensor, LoRA on a mesh and
    compress-seq on data / fsdp / tensor are no longer among them."""
    from v2pe_tpu_torch.train import cli

    argv = ["--tokenizer", "none", "--meta_path", "none", "--platform",
            "cpu"]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv + flags)
    args = cli.build_argparser().parse_args(argv + [
        "--use_8bit_optimizer", "--mesh_fsdp", "2", "--mesh_tensor", "2",
        "--use_llm_lora", "4", "--compress_seq", "--mesh_data", "2"])
    assert cli._unported(args) == []
