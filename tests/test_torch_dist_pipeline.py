"""The pipe axis of the port (``parallel/pipeline.py``): GPipe over a mesh
of processes (gloo on the CPU) against JAX's pipelined ``llm_forward``
under the same mesh on the 8 forced host devices (the setup of
``tests/test_pipeline.py``): the LLM of that test (8 layers, 64 wide, 4/2
heads) at pipe 4, pipe 2 x fsdp 2 and pipe 2 x tensor 2 in one spawn of 4
processes, and 8 microbatches at B = 8 on pipe 2 in a spawn of 2. fp32,
logits within JAX's own 2e-4. Also ``choose_microbatches`` against JAX's
over a grid, what a pipe rank holds, and what a pipe mesh refuses.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from v2pe_tpu.core.config import LLMConfig
from v2pe_tpu.core.config import MeshConfig as JMeshConfig
from v2pe_tpu.models.internlm2 import llm_forward as jax_llm_forward
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.parallel import context as jctx
from v2pe_tpu.parallel import pipeline as jpipe
from v2pe_tpu.parallel.mesh import make_mesh, param_sharding
from v2pe_tpu_torch.core import config as tconfig
from v2pe_tpu_torch.parallel import context as tctx
from v2pe_tpu_torch.parallel import pipeline as tpipe

from .test_torch_dist_mesh import tiny_cfg
from .torch_dist import Run, np_tree
from .torch_parity import port_config

LLM = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
           num_hidden_layers=8, num_attention_heads=4, num_key_value_heads=2)
# the meshes of the 4-process spawn, then the 2-process one
FOUR = {"pipe4": dict(pipe=4), "pipe2_fsdp2": dict(pipe=2, fsdp=2),
        "pipe2_tensor2": dict(pipe=2, tensor=2)}
TWO = {"pipe2_m8": dict(pipe=2)}
MICROBATCHES = {"pipe2_m8": 8}
ROWS = {"pipe2_m8": 8}


def pipe_cfg():
    return dataclasses.replace(tiny_cfg(), llm=dataclasses.replace(
        tiny_cfg().llm, **LLM))


def inputs(B: int, S: int = 64, seed: int = 1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, LLM["vocab_size"], (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (B, S)).copy()
    seg = np.ones((B, S), np.int32)
    seg[-1, S // 2:] = 2  # a second packed sequence in the last row
    return ids, pos, seg


def jax_pipelined(tree, cfg, mesh: dict, B: int, microbatches: int = 0):
    """JAX's ``llm_forward`` under the pipe mesh (jnp attention)."""
    mesh = make_mesh(JMeshConfig(**mesh))
    params = jax.device_put(tree["llm"], param_sharding(tree["llm"], mesh))
    ctx = jctx.ShardingContext(mesh=mesh, pipe_microbatches=microbatches)
    ids, pos, seg = (jnp.asarray(a) for a in inputs(B))

    def f(params, ids, pos, seg):
        with jctx.use_sharding(ctx):
            logits, _ = jax_llm_forward(params, cfg.llm, input_ids=ids,
                                        rope_pos_ids=pos, segment_ids=seg,
                                        attn_impl="jnp")
        return logits

    return np.asarray(jax.jit(f)(params, ids, pos, seg))


@pytest.fixture(scope="module")
def forward(jax8, tmp_path_factory):
    cfg = pipe_cfg()
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    runs = {}
    for group in (FOUR, TWO):
        B = ROWS.get(next(iter(group)), 4)
        ids, pos, seg = inputs(B)
        tasks = [dict(kind="pipe_forward", mesh=m,
                      microbatches=MICROBATCHES.get(k, 0))
                 for k, m in group.items()]
        spec = dict(cfg=port_config(cfg).to_json(), tree=tree, fwd_ids=ids,
                    fwd_pos=pos, fwd_seg=seg, img_context_id=0, tasks=tasks)
        world = int(np.prod(list(next(iter(group.values())).values())))
        run = Run(spec, world, tmp_path_factory.mktemp("pipe_fwd"))
        for i, key in enumerate(group):
            runs[key] = (run, i)
    want = {k: jax_pipelined(tree, cfg, m, ROWS.get(k, 4),
                             MICROBATCHES.get(k, 0))
            for k, m in {**FOUR, **TWO}.items()}
    return runs, want


@pytest.mark.parametrize("mesh", list(FOUR) + list(TWO))
def test_pipelined_forward_matches_jax_under_the_same_mesh(forward, mesh):
    """The port's GPipe forward (each rank its stage's layers, the
    microbatches handed on by P2P) equals JAX's pipelined forward; every
    rank ends with the same logits."""
    runs, want = forward
    run, at = runs[mesh]
    got = run.result()[at]
    np.testing.assert_allclose(got["logits"], want[mesh], atol=2e-4,
                               rtol=2e-4)
    assert got["spread"] == 0.0
    axes = {**FOUR, **TWO}[mesh]
    P, per = axes["pipe"], LLM["num_hidden_layers"] // axes["pipe"]
    # rank r is at pipe coordinate r // (the ranks of one stage), as JAX's
    # device order puts pipe outermost
    inner = len(got["held_layers"]) // P
    assert got["held_layers"] == [
        list(range((r // inner) * per, (r // inner + 1) * per))
        for r in range(len(got["held_layers"]))]


def test_a_pipe_mesh_refuses_what_jax_refuses(forward):
    """A KV cache under pipe raises JAX's ValueError, and so does a
    serving placement; compress-seq, whose layer loop has no pipe branch
    in JAX, is refused naming the known fault."""
    runs, _ = forward
    run, at = runs["pipe4"]
    refused = run.result()[at]["refused"]
    assert refused["kv cache"][0] == "ValueError"
    assert "KV-cache decode is not supported under a 'pipe' mesh" in \
        refused["kv cache"][1]
    assert refused["serving placement"][0] == "ValueError"
    assert refused["compress-seq"][0] == "NotImplementedError"
    assert "Known faults inside the reference" in refused["compress-seq"][1]


@pytest.mark.parametrize("n_pipe", [1, 2, 4])
def test_choose_microbatches_equals_jax(n_pipe, caplog):
    """Every (batch, dp, requested) of a grid: the same count, the same
    warning, the same ValueError."""
    for batch, dp, req in itertools.product(range(1, 17), (1, 2, 4),
                                            (0, 1, 2, 3, 8)):
        outs = []
        for fn in (jpipe.choose_microbatches, tpipe.choose_microbatches):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                try:
                    got = fn(batch, n_pipe, req, dp=dp)
                except ValueError as e:
                    got = ("ValueError", str(e))
            outs.append((got, [r.getMessage() for r in caplog.records]))
        assert outs[0] == outs[1], (batch, dp, req, outs)


def test_the_bubble_and_the_stages():
    assert tpipe.bubble(2, 4) == 1 / 5 and tpipe.bubble(4, 8) == 3 / 11
    with pytest.raises(ValueError, match="seq must be 1"):
        tctx.ShardingContext.from_mesh(tconfig.MeshConfig(pipe=2, seq=2))
    # one process holds no two stages
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tctx.ShardingContext.from_mesh(tconfig.MeshConfig(pipe=2))
    ctx = tctx.ShardingContext.from_mesh(tconfig.MeshConfig(seq=2),
                                         pipe_microbatches=4)
    assert (ctx.pipe_shards, ctx.pipe_microbatches, ctx.coord("pipe")) == \
        (1, 4, 0)
