"""The port's ``tensor`` axis: Megatron's split over heads and FFN width,
across processes (gloo on the CPU), against one single-process JAX step on
the combined batch; and the placement rules themselves.

The model has 8/4 LLM heads (so ``Hkv % 2 == 0`` leaves two KV groups a
rank) and a 4-head ViT with QK-RMSNorm, whose mean of squares runs over the
heads of both ranks. Tolerances as in ``tests/test_torch_dist_mesh.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from v2pe_tpu_torch.core import config as tconfig
from v2pe_tpu_torch.models.internlm2 import split_wqkv
from v2pe_tpu_torch.models.params import _meta_model
from v2pe_tpu_torch.parallel import mesh as tmesh

from .test_torch_dist_mesh import TC, check_against_jax, start_runs, tiny_cfg

MESHES = {"tensor2": dict(tensor=2), "fsdp2_tensor2": dict(fsdp=2, tensor=2)}
# the optimizer's knobs on the shards: the clip active (the grad norm is
# about 0.6), layer decay in both towers, the projector frozen
KNOBS = dict(TC, max_grad_norm=0.5, vit_layer_decay_rate=0.9,
             llm_layer_decay_rate=0.9, freeze_mlp=True)


def cfg_4kv():
    cfg = tiny_cfg(num_attention_heads=8, num_key_value_heads=4)
    return dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, qk_normalization=True))


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """Both meshes' two steps, and four micro-batches making two updates
    (``grad_accum_steps=2``, optax's MultiSteps in JAX) on fsdp 2 x tensor
    2: every run started, then JAX's two references."""
    steps = start_runs(cfg_4kv(), MESHES, tmp_path_factory, "tensor",
                       tc=KNOBS)
    accum = start_runs(cfg_4kv(), {"fsdp2_tensor2": MESHES["fsdp2_tensor2"]},
                       tmp_path_factory, "accum",
                       tc=dict(TC, grad_accum_steps=2), n_batches=4)
    return {k: (started, reference())
            for k, (started, reference) in (("steps", steps),
                                            ("accum", accum))}


@pytest.fixture(scope="module")
def runs(all_runs):
    return all_runs["steps"]


@pytest.fixture(scope="module")
def accum_run(all_runs):
    return all_runs["accum"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tensor_split_train_steps_match_jax(runs, mesh):
    """Two steps with the heads and FFN width split over 2 tensor ranks
    (and the rows over fsdp) equal JAX's single-process steps, clipped by
    the global norm, with layer decay and a frozen projector; every unit
    split, the vocab whole."""
    started, want = runs
    (got,) = started[mesh].result()
    split = set(got["rules"])
    assert {"llm.layers.0.wqkv.weight", "llm.layers.1.w2.weight",
            "vision.layers.0.qkv.bias", "vision.layers.1.q_norm",
            "vision.layers.0.fc2.weight", "mlp1.fc1.weight"} <= split
    assert not split & {"llm.tok_embeddings.weight", "llm.output.weight",
                        "llm.layers.0.attention_norm", "mlp1.fc2.bias",
                        "vision.layers.0.proj.bias"}
    check_against_jax(got, want)
    assert max(got["grad_norm"]) > KNOBS["max_grad_norm"]  # it clipped


def test_grad_accumulation_under_the_mesh_matches_jax(accum_run):
    """The running mean of the shards' gradients over two micro-batches,
    then one update, as JAX's MultiSteps: every micro-step's loss and grad
    norm, and the parameters after the two updates."""
    started, want = accum_run
    (got,) = started["fsdp2_tensor2"].result()
    assert len(got["loss"]) == 4
    check_against_jax(got, want)


# ------------------------------------------------------ the placement rules


def test_rules_split_units_the_axis_divides_and_never_the_vocab():
    """``_fit_spec``'s rule at InternVL2-2B's widths: over 2 every unit
    splits; over 3 the 8 KV heads and the 16 ViT heads stay whole, the FFN
    widths (8192, 4096) and 2048 do not divide either; the 92,553-entry
    vocab never splits."""
    cfg = tconfig.internvl2_2b()
    model = _meta_model(cfg)
    two = tmesh.tensor_rules(model, cfg, 2)
    assert two["llm.layers.0.wqkv.weight"] == tmesh.TensorRule(0, 1,
                                                               "llm_attn")
    assert two["vision.layers.3.qkv.weight"].blocks == 3
    assert two["llm.layers.5.wo.weight"].dim == 1
    assert "llm.output.weight" not in two
    assert "llm.tok_embeddings.weight" not in two
    assert "llm.layers.0.wo.bias" not in two  # InternLM2 has none anyway
    n_split = len(two)
    assert n_split == 24 * 5 + 24 * 6 + 3
    assert tmesh.tensor_rules(model, cfg, 3) == {}
    assert tmesh.tensor_rules(model, cfg, 1) == {}


@pytest.mark.parametrize("rule,shape", [
    (tmesh.TensorRule(0, 1, "llm_attn"), (12, 5)),
    (tmesh.TensorRule(0, 3, "vit_attn"), (12, 5)),
    (tmesh.TensorRule(1, 1, "llm_mlp"), (5, 12)),
    (tmesh.TensorRule(0, 3, "vit_attn"), (12,)),
])
def test_tensor_slices_join_back(rule, shape):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    parts = [tmesh.tensor_slice(x, rule, 2, i) for i in range(2)]
    assert all(p.shape[rule.dim] == shape[rule.dim] // 2 for p in parts)
    assert torch.equal(tmesh.tensor_join(parts, rule), x)
    if rule.blocks == 3:  # [q | k | v]: rank 0 holds the first half of each
        flat = x.reshape(3, -1) if x.ndim == 1 else x.reshape(3, 4, -1)
        assert torch.equal(parts[0].reshape(flat[:, :2].shape),
                           flat[:, :2])


def test_wqkv_rows_of_whole_kv_groups_give_those_heads():
    """A contiguous half of the interleaved ``wqkv`` rows is two whole KV
    groups: ``split_wqkv`` on it gives the query heads 0-3 and KV heads 0-1
    of the whole split (the rotary and the flash call then see a rank's
    heads)."""
    llm = tconfig.LLMConfig(vocab_size=16, hidden_size=64,
                            intermediate_size=32, num_hidden_layers=1,
                            num_attention_heads=8, num_key_value_heads=4)
    qkv = torch.randn(2, 3, (8 + 2 * 4) * 8)
    q, k, v = split_wqkv(qkv, llm)
    for r in range(2):
        half = tmesh.tensor_slice(qkv, tmesh.TensorRule(2, 1, "llm_attn"), 2,
                                  r)
        ql, kl, vl = split_wqkv(half, llm, kv_heads=2)
        assert torch.equal(ql, q[:, :, 4 * r:4 * r + 4])
        assert torch.equal(kl, k[:, :, 2 * r:2 * r + 2])
        assert torch.equal(vl, v[:, :, 2 * r:2 * r + 2])
