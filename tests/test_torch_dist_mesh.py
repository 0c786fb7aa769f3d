"""The port's training step across processes (gloo on the CPU) against one
single-process JAX step on the combined batch, as ``tests/test_multihost.py``
holds the JAX package's multi-host step: the ``data``, ``fsdp`` and ``seq``
axes (the scan ring over real P2P) at debug_tiny's widths (4/2 LLM heads,
2 layers; 56-pixel tiles to keep the CPU's ViT small).

Each mesh runs two optimizer steps in 2 or 4 worker processes
(``tests/torch_dist_worker.py``); the JAX reference runs in this process
meanwhile. fp32 throughout: loss and grad norm within 1e-5 relative, every
parameter after the steps (gathered whole) within 2e-5 absolute.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from v2pe_tpu.core.config import debug_tiny
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.models.params import _jax_state_dict

from .torch_dist import Run, np_tree
from .torch_parity import port_config

B, S = 2, 256
# the CLI's default learning rate: one Adam step moves an element by about
# lr, and g / (|g| + eps) turns fp32 sums in another order into a part of
# that where g is near zero (1e-3 left 1.7e-4 between JAX and the port even
# in one process)
TC = dict(learning_rate=4e-5, warmup_steps=0, total_steps=10,
          weight_decay=0.01, max_grad_norm=1.0)
MESHES = {"data2": dict(data=2), "fsdp2": dict(fsdp=2),
          "seq2": dict(seq=2), "fsdp2_seq2": dict(fsdp=2, seq=2)}
# the port's remat mode of each run (JAX's is 'full'; recomputation does
# not change an fp32 result): FSDP2's hooks under each checkpointing
REMAT = {"fsdp2": "block2", "fsdp2_seq2": "attn_saved"}


def tiny_cfg(**llm):
    """debug_tiny's widths with 56-pixel tiles (4 image tokens a tile)."""
    cfg = debug_tiny()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, image_size=56),
        llm=dataclasses.replace(cfg.llm, **llm), rope_pos_id_stride=2)


def global_batches(cfg, seq_shards: int = 2, n: int = 2, seed: int = 0):
    """``n`` global batches of B rows (the zigzag layout of ``seq_shards``
    ranks), the second row weighted half and its first quarter not at all,
    so that the ranks of a data axis carry unequal weight."""
    out = []
    for i in range(n):
        b = jsynth.make_synthetic_batch(cfg, B, S, tiles_per_row=1,
                                        seq_shards=seq_shards, seed=seed + i)
        w = np.array(b["loss_weight"], np.float32)
        w[1] *= 0.5
        w[1, :S // 4] = 0
        b["loss_weight"] = w
        out.append({k: np.asarray(v) for k, v in b.items()})
    return out


def jax_reference(cfg, tree, batches, tc):
    """Single-process JAX steps (jnp attention, remat) on the combined
    batches: losses, grad norms, parameters in the port's layout."""
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc), tree)
    state = tx.init(tree)
    fn = jstep.make_train_step(cfg, tx, None, jsynth.IMG_CONTEXT_ID,
                               attn_impl="jnp", remat=True, donate=False)
    params, losses, norms = tree, [], []
    for b in batches:
        params, state, m = fn(params, state, {k: jax.numpy.asarray(v)
                                              for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _jax_state_dict(np_tree(params), port_config(cfg))


def start_runs(cfg, meshes, tmp_path_factory, name, tc=TC, n_batches=2):
    """Start every mesh's run; returns (runs by mesh, a function that
    computes JAX's reference, to call while they run)."""
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    batches = global_batches(cfg, n=n_batches)
    spec = dict(cfg=port_config(cfg).to_json(), tree=tree, batches=batches,
                img_context_id=jsynth.IMG_CONTEXT_ID)
    runs = {}
    for key, mesh in meshes.items():
        task = dict(kind="train", mesh=mesh, tc=tc,
                    remat=REMAT.get(key, "full"))
        runs[key] = Run(dict(spec, tasks=[task]),
                        int(np.prod(list(mesh.values()))),
                        tmp_path_factory.mktemp(f"{name}_{key}"))
    return runs, lambda: jax_reference(cfg, tree, batches, tc)


def check_against_jax(got, want):
    losses, norms, params = want
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5, atol=0)
    assert got["params"].keys() == params.keys()
    for n, p in got["params"].items():
        np.testing.assert_allclose(p, params[n], rtol=0, atol=2e-5,
                                   err_msg=n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started, reference = start_runs(tiny_cfg(), MESHES, tmp_path_factory,
                                    "mesh")
    return started, reference()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_steps_across_processes_match_jax(runs, mesh):
    """Two steps on the mesh equal JAX's two single-process steps on the
    combined batch: rows over (data, fsdp), the scan ring over seq."""
    started, want = runs
    (got,) = started[mesh].result()
    assert got["rules"] == []  # no tensor axis: nothing split by heads
    # the decoder's attention went round the ring across ranks, each rank
    # with its half of the sequence and all 4 query heads
    seq = MESHES[mesh].get("seq", 1)
    rows = B // MESHES[mesh].get("data", 1) // MESHES[mesh].get("fsdp", 1)
    assert got["ring_q_shapes"] == ([(rows, S // seq, 4, 16)] if seq > 1
                                    else [])
    check_against_jax(got, want)
