"""LoRA on a mesh of processes (gloo on the CPU) against JAX's LoRA step
in one process on the combined batch: the base placed as
``parallel/mesh.py:shard_model`` places a model (a frozen view of it,
``place_lora``), the adapters beside it, whole over ``data`` and ``fsdp``
and split over ``tensor`` with their targets.

One spawn of 4 processes at fsdp 2 x tensor 2 (AdamW, int8 Adam,
``freeze_llm``) and one at data 2 x fsdp 2, on the 8/4-head model of
``tests/test_torch_dist_tensor.py`` with adapters of rank 4 (LLM) and 2
(ViT) whose ``b`` is seeded away from 0, on two 4-row batches. fp32:
loss and grad norm within
1e-5 relative, every adapter tensor within 2e-5.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from v2pe_tpu.models import lora as jlora
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.models import lora as tlora

from .test_torch_dist_mesh import TC, global_batches
from .test_torch_dist_misc import _stack
from .test_torch_dist_tensor import cfg_4kv
from .torch_dist import Run, np_tree
from .torch_parity import port_config

# the spawns' tasks: (mesh, optimizer knobs)
CASES = {
    "fsdp2_tensor2": (dict(fsdp=2, tensor=2), TC),
    "fsdp2_tensor2_int8": (dict(fsdp=2, tensor=2),
                           dict(TC, use_8bit_optimizer=True)),
    "fsdp2_tensor2_freeze_llm": (dict(fsdp=2, tensor=2),
                                 dict(TC, freeze_llm=True)),
    "data2_fsdp2": (dict(data=2, fsdp=2), TC),
}


def jax_adapters(tree, seed=1):
    """JAX's adapters of both towers, ``b`` seeded away from 0 (a fresh
    ``b`` makes the first step's ``a`` gradient 0)."""
    ad = jlora.build_lora(jax.random.PRNGKey(seed), tree, backbone_r=2,
                          llm_r=4)
    rng = np.random.default_rng(seed)
    ad = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32) if str(getattr(p[-1], "key", "")) == "b" else x,
        ad, is_leaf=lambda x: x is None)
    return jax.tree.map(np.asarray, ad)


def adapter_state(tree, names) -> dict:
    """A JAX adapter tree under the port's adapter names and layouts."""
    lora = tlora.from_jax_lora(tree)
    out = {}
    for name, (path, layer, transposed) in tlora.lora_leaf_map(lora).items():
        a = tree
        for k in path:
            a = a[k]
        a = np.asarray(a)
        if layer is not None:
            a = a[layer]
        out[name] = a.T if transposed else a
    assert set(out) == set(names)
    return out


def jax_lora_steps(cfg, tree, ad, batches, tc):
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc), ad)
    state = tx.init(ad)
    fn = jstep.make_train_step(cfg, tx, None, jsynth.IMG_CONTEXT_ID,
                               attn_impl="jnp", remat=True, donate=False,
                               lora=True)
    losses, norms = [], []
    for b in batches:
        ad, state, m = fn(ad, state, {k: jax.numpy.asarray(v)
                                      for k, v in b.items()}, tree)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, ad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = cfg_4kv()
    tree = np_tree(jax_init(jax.random.PRNGKey(0), cfg))
    ad = jax_adapters(tree)
    # 4-row batches: a row for each (data, fsdp) rank of data 2 x fsdp 2
    batches = [_stack(global_batches(cfg, n=2, seed=2 * i)) for i in range(2)]
    spec = dict(cfg=port_config(cfg).to_json(), tree=tree, adapters=ad,
                batches=batches, img_context_id=jsynth.IMG_CONTEXT_ID)
    spawns = {}
    for key, (mesh, tc) in CASES.items():
        spawns.setdefault(tuple(sorted(mesh.items())), []).append(
            (key, dict(kind="lora", mesh=mesh, tc=tc)))
    started = {}
    for i, (mesh, tasks) in enumerate(spawns.items()):
        run = Run(dict(spec, tasks=[t for _, t in tasks]),
                  int(np.prod([v for _, v in mesh])),
                  tmp_path_factory.mktemp(f"lora{i}"))
        for j, (key, _) in enumerate(tasks):
            started[key] = (run, j)
    want = {key: jax_lora_steps(cfg, tree, ad, batches, tc)
            for key, (_, tc) in CASES.items()}
    return started, want, ad


@pytest.mark.parametrize("case", list(CASES))
def test_lora_steps_on_a_mesh_match_jax(runs, case):
    """Two LoRA steps on the mesh equal JAX's on the combined batch: loss,
    grad norm, every adapter tensor; the base model left as it was."""
    started, want, ad0 = runs
    run, at = started[case]
    got = run.result()[at]
    losses, norms, ad = want[case]
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5, atol=0)
    ref = adapter_state(ad, got["adapters"])
    start = adapter_state(ad0, got["adapters"])
    for n, t in got["adapters"].items():
        np.testing.assert_allclose(t, ref[n], rtol=0, atol=2e-5, err_msg=n)
    assert got["base_unchanged"]
    mesh = CASES[case][0]
    if mesh.get("tensor", 1) > 1:  # B of column targets, A of row targets
        assert "llm.layers.0.wqkv.B" in got["rules"]
        assert "llm.layers.1.w2.A" in got["rules"]
        assert "vision.layers.0.qkv.B" in got["rules"]
        assert "llm.layers.0.wqkv.A" in got["partial"]
        assert "vision.layers.1.proj.B" in got["partial"]
    else:
        assert got["rules"] == [] and got["partial"] == []
    if CASES[case][1].get("freeze_llm"):  # JAX's mask: the LLM's frozen
        for n, t in got["adapters"].items():
            moved = not np.array_equal(t, start[n])
            assert moved == (n.startswith("vision.")
                             and not n.endswith(".alpha")), n
