"""Training on the pipe axis (``parallel/pipeline.py``) across processes
(gloo on the CPU) against one single-process JAX step on the combined
batch, as ``tests/test_torch_dist_mesh.py`` holds the other axes (JAX's
own ``test_pipeline_train_step_matches_unpipelined`` ties its pipelined
step to that step).

One spawn of 4 processes: two steps at pipe 2 x data 2 with 2 microbatches
(AdamW), and at pipe 2 x fsdp 2 with int8 Adam on the 32-wide model of
``tests/test_torch_dist_int8.py`` (its stacked norms' 256-value blocks span
both layers, so a block is cut between the stages). One spawn of 2
processes at pipe 2: a save after step 1 and a resume, and LoRA. 4-row
batches at debug_tiny's widths, one decoder layer a stage. fp32: loss and
grad norm within 1e-5 relative, every parameter gathered whole within
2e-5; the gradients of everything outside the decoder layers equal on the
pipe ranks of a coordinate.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params

from .test_torch_dist_int8 import (INT8, cfg_int8, check_moments,
                                   jax_int8_state, jax_steps)
from .test_torch_dist_lora import adapter_state, jax_adapters, jax_lora_steps
from .test_torch_dist_mesh import (TC, check_against_jax, global_batches,
                                   jax_reference, tiny_cfg)
from .test_torch_dist_misc import _stack
from .torch_dist import Run, np_tree
from .torch_parity import port_config


def four_rows(cfg, seed: int = 0) -> list:
    """Two global batches of 4 rows (two of ``global_batches``' each)."""
    return [_stack(global_batches(cfg, n=2, seed=seed + 2 * i))
            for i in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns started, then JAX's references computed meanwhile."""
    cfg, cfg8 = tiny_cfg(), cfg_int8()
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    tree8 = np_tree(jax_init(jax.random.PRNGKey(0), cfg8))
    batches, batches8 = four_rows(cfg), four_rows(cfg8, seed=10)
    ad = jax_adapters(tree)
    spec = dict(cfg=port_config(cfg).to_json(), tree=tree, batches=batches,
                adapters=ad, img_context_id=jsynth.IMG_CONTEXT_ID)
    four = Run(dict(spec, tasks=[
        dict(kind="train", mesh=dict(pipe=2, data=2), tc=TC,
             microbatches=2),
        dict(kind="train", mesh=dict(pipe=2, fsdp=2), tc=INT8,
             cfg=port_config(cfg8).to_json(), tree=tree8,
             batches=batches8, remat="block2")]),
        4, tmp_path_factory.mktemp("pipe_train4"))
    root = tmp_path_factory.mktemp("pipe_train2")
    two = Run(dict(spec, tasks=[
        dict(kind="resume", mesh=dict(pipe=2), tc=TC,
             dir=str(root / "ckpt"), compare=True),
        dict(kind="lora", mesh=dict(pipe=2), tc=TC)]), 2, root)
    want = {"data2": jax_reference(cfg, tree, batches, TC),
            "fsdp2_int8": jax_steps(cfg8, tree8, batches8),
            "first_step": jax_reference(cfg, tree, batches[:1], TC),
            "lora": jax_lora_steps(cfg, tree, ad, batches, TC)}
    return dict(four=four, two=two, root=root, cfg=cfg, tree=tree, ad=ad,
                want=want)


@pytest.mark.parametrize("case", ["data2", "fsdp2_int8"])
def test_pipe_train_steps_match_jax(runs, case):
    """Two steps on the pipe mesh equal JAX's two single-process steps on
    the combined batch; int8 Adam's codes and scales too, the blocks cut
    between the stages included."""
    got = runs["four"].result()[0 if case == "data2" else 1]
    if case == "data2":
        check_against_jax(got, runs["want"][case])
    else:
        want, jstate = runs["want"][case]
        check_against_jax(got, want)
        check_moments(got["moments"], jax_int8_state(jstate, got["moments"]),
                      scale_tol=1e-5, code_frac=5e-5)
    # a stage's layer on each pipe rank: ranks 0-1 pipe 0, ranks 2-3 pipe 1
    assert got["held_layers"] == [[0], [0], [1], [1]]


@pytest.mark.parametrize("case", [0, 1])
def test_replicated_gradients_are_equal_on_the_pipe_ranks(runs, case):
    """The gradients of the ViT, the projector, the embedding, the final
    norm and the head come out the same on every pipe rank (the output
    and the input gradient made whole over ``pipe``), so nothing is summed
    over it."""
    got = runs["four"].result()[case]
    assert got["replicated"] > 10
    assert got["pipe_spread"] == 0.0


def test_a_pipe_checkpoint_resumes_and_loads_into_one_process(runs):
    """A checkpoint written at pipe 2 holds every stage's layers: a fresh
    pipe 2 model restored from it takes step 2 to the unbroken run's loss
    and weights, and a one-process model loads it whole, equal to JAX's
    weights after the first step."""
    got = runs["two"].result()[0]
    assert got["resumed"] == got["unbroken"] and got["step"] == 1
    assert got["files"] == ["data_state_p0.pkl", "data_state_p1.pkl",
                            "meta.json", "opt_state.pt", "params.pt"]
    for n, p in got["params"].items():
        np.testing.assert_array_equal(p, got["unbroken_params"][n],
                                      err_msg=n)
    sd = torch.load(runs["root"] / "ckpt" / "step_00000001" / "params.pt")
    model = from_jax_params(runs["tree"], port_config(runs["cfg"]))
    model.load_state_dict(sd, strict=True)
    _, _, want = runs["want"]["first_step"]
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n], rtol=0, atol=2e-5,
                                   err_msg=n)


def test_lora_at_pipe2_matches_jax(runs):
    """LoRA through the pipelined forward: each stage trains its layers'
    adapters, the ViT's on both; losses, grad norms and every adapter,
    gathered whole, equal JAX's."""
    got = runs["two"].result()[1]
    losses, norms, ad = runs["want"]["lora"]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5, atol=0)
    ref = adapter_state(ad, got["adapters"])
    assert any(n.startswith("llm.layers.1.") for n in ref)
    for n, t in got["adapters"].items():
        np.testing.assert_allclose(t, ref[n], rtol=0, atol=2e-5, err_msg=n)
    assert got["base_unchanged"]
