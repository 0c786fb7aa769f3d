"""The fused ring (#11) across processes (``ring_fused.py:
dist_fused_ring_fwd``, gloo on the CPU): each rank runs the fused forward
for its own queries over every rank's chunk, and its backward is the scan
ring's P2P second pass. On the CPU the chunks are all-gathered and the
kernel's plain sweep runs; on the card the peers' chunks are mapped by
CUDA IPC (``chip_smoke.py``, ``phase_fused_two_ranks``).

At seq 2 (2 processes) and seq 4 (4): the output and the gradients of q,
k and v against ``ring.ring_flash_attention`` with every shard in one
process (the ``task_ring`` pattern), and the forward's (out, lse) against
the one-process fused forward's rows; then two fused train steps at
``MeshConfig(seq=2)`` against JAX's single-process step on the combined
batch, as the ``seq2`` mesh of ``tests/test_torch_dist_mesh.py``.
"""

from __future__ import annotations

import jax
import pytest

from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import synth as jsynth

from .test_torch_dist_mesh import (B, S, TC, check_against_jax,
                                   global_batches, jax_reference, tiny_cfg)
from .torch_dist import Run, np_tree
from .torch_parity import port_config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = tiny_cfg()
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    batches = global_batches(cfg)
    spec = dict(cfg=port_config(cfg).to_json(), tree=tree, batches=batches,
                img_context_id=jsynth.IMG_CONTEXT_ID)
    two = Run(dict(spec, tasks=[
        dict(kind="fused_ring"),
        dict(kind="train", mesh=dict(seq=2), tc=TC, ring_mode="fused")]),
        2, tmp_path_factory.mktemp("fused2"))
    four = Run(dict(spec, tasks=[dict(kind="fused_ring")]), 4,
               tmp_path_factory.mktemp("fused4"))
    return {2: two, 4: four}, jax_reference(cfg, tree, batches, TC)


@pytest.mark.parametrize("seq", [2, 4])
def test_fused_ring_across_processes_equals_the_one_process_ring(runs, seq):
    """Each rank's rows of the output and of the q, k, v gradients equal
    the one-process scan ring's (the same flash sums in another order),
    and the forward's out and lse the one-process fused forward's, bit for
    bit."""
    errors = runs[0][seq].result()[0]["errors"]
    assert max(errors[:4]) <= 2e-6, errors
    assert errors[4:] == [0.0, 0.0], errors


def test_fused_train_steps_across_processes_match_jax(runs):
    """Two steps at seq 2 with ``ring_mode='fused'``: the decoder's
    attention went through the fused forward across the ranks, and the
    losses, grad norms and parameters equal JAX's on the combined
    batch."""
    got = runs[0][2].result()[1]
    # every fused call: this rank's half of the sequence, all 4 query heads
    assert ("fused", B, S // 2, 4, 16) in got["ring_q_shapes"]
    check_against_jax(got, runs[1])
