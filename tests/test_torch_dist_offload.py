"""The offloaded int8 optimizer across processes (gloo on the CPU): two
ranks at fsdp 2, each keeping its share of the int8 state in host memory
and staging it through the device, against the resident int8 run on the
same mesh; then a save and resume of the offloaded run.

At these widths (``tests/test_torch_dist_int8.py``'s D 32 and FFN 1024)
most leaves have blocks cut between the ranks, which meet on the device
before their staged update, and ``w1`` / ``w3`` hold whole blocks on each
rank. Tolerances: none; the offloaded run equals the resident one to the
bit (the staged update is the resident update), and the resumed run the
unbroken one.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import synth as jsynth

from .test_torch_dist_int8 import INT8, cfg_int8
from .test_torch_dist_mesh import global_batches
from .torch_dist import Run, np_tree
from .torch_parity import port_config

MESH = dict(fsdp=2)
OFFLOAD = dict(INT8, offload_optimizer=True)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    cfg = cfg_int8()
    root = tmp_path_factory.mktemp("offload_fsdp2")
    spec = dict(cfg=port_config(cfg).to_json(),
                tree=np_tree(jax_init(jax.random.PRNGKey(0), cfg)),
                batches=global_batches(cfg),
                img_context_id=jsynth.IMG_CONTEXT_ID,
                tasks=[dict(kind="train", mesh=MESH, tc=INT8),
                       dict(kind="train", mesh=MESH, tc=OFFLOAD),
                       dict(kind="resume", mesh=MESH, tc=OFFLOAD,
                            dir=str(root / "ckpt"), compare=True)])
    return Run(spec, 2, root).result()


def test_offloaded_steps_on_fsdp2_equal_resident_to_the_bit(result):
    """Two steps: losses, grad norms, parameters, and the int8 state
    gathered to one device's layout, equal bit for bit; each rank held its
    share of the state, not a replica."""
    resident, offloaded = result[0], result[1]
    assert offloaded["loss"] == resident["loss"]
    assert offloaded["grad_norm"] == resident["grad_norm"]
    for n, p in resident["params"].items():
        np.testing.assert_array_equal(offloaded["params"][n], p, err_msg=n)
    assert set(offloaded["moments"]) == set(resident["moments"])
    for key, mom in resident["moments"].items():
        for t, v in mom.items():
            np.testing.assert_array_equal(offloaded["moments"][key][t], v,
                                          err_msg=f"{key} {t}")
    assert offloaded["state_bytes"] == resident["state_bytes"]
    whole = sum(v.nbytes for mom in resident["moments"].values()
                for v in mom.values())
    assert max(offloaded["state_bytes"]) < 0.6 * whole


def test_offloaded_resume_on_fsdp2_equals_the_unbroken_run(result):
    """Rank 0 writes one device's int8 state from the ranks' host shares;
    a fresh placed model and offloaded optimizer restored from it take
    step 2 to the unbroken run's loss, parameters, codes and scales."""
    got = result[2]
    assert got["resumed"] == got["unbroken"] and got["step"] == 1
    for n, p in got["params"].items():
        np.testing.assert_array_equal(p, got["unbroken_params"][n],
                                      err_msg=n)
    for key, mom in got["resumed_moments"].items():
        for t, v in mom.items():
            np.testing.assert_array_equal(v, got["unbroken_moments"][key][t],
                                          err_msg=f"{key} {t}")
