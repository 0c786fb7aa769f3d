"""The sequence-classification head of the port
(``models/sequence_classification.py``) against the JAX package's on the
CPU, fp32, a 2-layer decoder: the pooling quirks, pooled logits within
2e-5, the three losses, the init's shapes, and the HF-name converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig
from v2pe_tpu.models import sequence_classification as jsc
from v2pe_tpu_torch.models import sequence_classification as tsc

from .torch_parity import port_config

PAD = 2
TOL = dict(atol=2e-5, rtol=2e-5)


def _cfg():
    return LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2)


def _ids():
    """Row 0 has no pad, row 1 pads from 5, row 2 has a pad at 0, row 3 a
    pad in the middle and at the end."""
    ids = np.random.default_rng(0).integers(3, 64, (4, 12)).astype(np.int32)
    ids[1, 5:] = PAD
    ids[2, 0] = PAD
    ids[3, 4], ids[3, 10:] = PAD, PAD
    return ids


def _models(num_labels, seed=0):
    cfg = _cfg()
    tree = jsc.init_seq_cls_params(jax.random.PRNGKey(seed), cfg, num_labels)
    return cfg, tree, tsc.seq_cls_from_jax(jax.tree.map(np.asarray, tree),
                                           port_config(cfg))


@pytest.mark.parametrize("pad", [PAD, None])
def test_pooling_matches_jax_and_negative_indexing(pad):
    ids = _ids()
    x = np.random.default_rng(1).standard_normal((4, 12, 5)).astype(
        np.float32)
    want = np.asarray(jsc.pool_last_token(jnp.asarray(x), jnp.asarray(ids),
                                          pad))
    got = tsc.pool_last_token(torch.from_numpy(x), torch.from_numpy(ids), pad)
    np.testing.assert_array_equal(got.numpy(), want)
    if pad is not None:  # torch's own index -1 wrap, as the reference has it
        at = torch.eq(torch.from_numpy(ids), pad).int().argmax(-1) - 1
        np.testing.assert_array_equal(
            got.numpy(), torch.from_numpy(x)[torch.arange(4), at].numpy())
        np.testing.assert_array_equal(got[0].numpy(), x[0, -1])
        np.testing.assert_array_equal(got[2].numpy(), x[2, -1])
        np.testing.assert_array_equal(got[3].numpy(), x[3, 3])
    else:
        np.testing.assert_array_equal(got.numpy(), x[:, -1])


def test_init_matches_jax_shapes_and_scales():
    cfg, tree, model = _models(3)
    got = tsc.init_seq_cls_params(torch.Generator().manual_seed(0),
                                  port_config(cfg), 3)
    want = tsc.seq_cls_from_jax(jax.tree.map(np.asarray, tree),
                                port_config(cfg))
    sd, ref = got.state_dict(), want.state_dict()
    assert sd.keys() == ref.keys() and "output.weight" not in sd
    for k in ref:
        assert sd[k].shape == ref[k].shape, k
        if k.endswith(("norm", "norm.weight")) or k == "norm":
            assert torch.equal(sd[k], ref[k]), k
        else:
            assert abs(float(sd[k].std()) - 0.02) < 0.005, k


@pytest.mark.parametrize("problem", ["regression",
                                     "single_label_classification",
                                     "multi_label_classification"])
def test_forward_and_losses_match_jax(problem):
    """Pooled logits within 2e-5 and the loss of each problem type (each
    resolved from the labels, as HF does) within 2e-5."""
    n = 1 if problem == "regression" else 3
    cfg, tree, model = _models(n)
    ids = _ids()
    rng = np.random.default_rng(2)
    labels = {"regression": rng.standard_normal(4).astype(np.float32),
              "single_label_classification": rng.integers(0, n, 4),
              "multi_label_classification": rng.integers(
                  0, 2, (4, n)).astype(np.float32)}[problem]
    seg = (ids != PAD).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.float32) * 0.5,
                          (4, 12)).copy()
    jp, jl = jsc.seq_cls_forward(
        tree, cfg, input_ids=jnp.asarray(ids), labels=jnp.asarray(labels),
        pad_token_id=PAD, segment_ids=jnp.asarray(seg),
        rope_pos_ids=jnp.asarray(pos), attn_impl="jnp")
    tp, tl = tsc.seq_cls_forward(
        model, port_config(cfg), input_ids=torch.from_numpy(ids),
        labels=torch.from_numpy(labels), pad_token_id=PAD,
        segment_ids=torch.from_numpy(seg), rope_pos_ids=torch.from_numpy(pos))
    assert tsc.resolve_problem_type(n, torch.from_numpy(labels)) == problem
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    # and HF's own loss modules on the port's pooled logits
    lt = torch.from_numpy(labels)
    want = {"regression": lambda: torch.nn.MSELoss()(tp.squeeze(),
                                                     lt.squeeze()),
            "single_label_classification": lambda: torch.nn.CrossEntropyLoss(
            )(tp.view(-1, n), lt.view(-1).long()),
            "multi_label_classification": lambda: torch.nn.BCEWithLogitsLoss(
            )(tp, lt)}[problem]()
    torch.testing.assert_close(tl, want, rtol=1e-6, atol=1e-6)
    p0, none = tsc.seq_cls_forward(model, port_config(cfg),
                                   input_ids=torch.from_numpy(ids))
    assert none is None and p0.shape == (4, n)
    with pytest.raises(ValueError):
        tsc.seq_cls_forward(model, port_config(cfg),
                            input_ids=torch.from_numpy(ids),
                            labels=torch.from_numpy(labels),
                            problem_type="ranking")


def test_hf_converter_matches_jax():
    cfg = _cfg()
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    rows = (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) \
        * cfg.head_dim
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {"model.tok_embeddings.weight": t(cfg.vocab_size, H),
          "model.norm.weight": t(H), "score.weight": t(3, H)}
    for i in range(L):
        sd[f"model.layers.{i}.attention_norm.weight"] = t(H)
        sd[f"model.layers.{i}.ffn_norm.weight"] = t(H)
        sd[f"model.layers.{i}.attention.wqkv.weight"] = t(rows, H)
        sd[f"model.layers.{i}.attention.wo.weight"] = t(H, H)
        sd[f"model.layers.{i}.feed_forward.w1.weight"] = t(I, H)
        sd[f"model.layers.{i}.feed_forward.w3.weight"] = t(I, H)
        sd[f"model.layers.{i}.feed_forward.w2.weight"] = t(H, I)
    tree = jsc.convert_seq_cls_state_dict(sd, cfg)
    got = tsc.convert_seq_cls_state_dict(sd, port_config(cfg))
    want = tsc.seq_cls_from_jax(jax.tree.map(np.asarray, tree),
                                port_config(cfg)).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = tsc.InternLM2ForSequenceClassification(port_config(cfg), 3)
    model.load_state_dict(got)
    ids = _ids()
    jp, _ = jsc.seq_cls_forward(tree, cfg, input_ids=jnp.asarray(ids),
                                pad_token_id=PAD, attn_impl="jnp")
    tp, _ = tsc.seq_cls_forward(model, port_config(cfg),
                                input_ids=torch.from_numpy(ids),
                                pad_token_id=PAD)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), **TOL)
