"""Compress-seq in the port (``models/compress_seq.py``, its route in
``internvl_chat.forward``, the train step and the CLI) against the JAX
package's on the CPU, fp32, tiny models: every helper, the hierarchical
forward ('add' and 'cross-attn', with and without packing segments) and
the fuse-only branch within 2e-5, every gradient leaf against
``jax.grad``, two train steps with a LayerScale lr scale, the CLI, and
the sharded-sequence refusal."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.models import compress_seq as jcs
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.core import checkpoint as ckpt
from v2pe_tpu_torch.models import compress_seq as tcs
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params
from v2pe_tpu_torch.train import optimizer as topt
from v2pe_tpu_torch.train import train_step as tstep

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import toy_dataset  # noqa: F401  (a fixture)
from .test_torch_train import IMG, LEAF_TOL, LOSS_RTOL, _batch, _torch_batch
from .torch_parity import port_config, run_parity

TOL = dict(atol=2e-5, rtol=2e-5)


def _cfg(fuse="add", chunks=4):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=300, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2),
        rope_pos_id_stride=2, compress_seq=True, fuse_method=fuse,
        chunk_num=chunks)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(fuse, seed=0, gamma=None):
    """The JAX tree with its compress parameters (LayerScale ``gamma`` in
    place of 1e-3 when given, so the fuse moves the logits) and the port's
    model from it."""
    cfg = _cfg(fuse)
    tree = jax_init(jax.random.PRNGKey(seed), cfg)
    tree["compress"] = jcs.init_compress_params(tree["llm"], cfg=cfg.llm,
                                                fuse_method=fuse)
    if gamma is not None:
        tree["compress"]["layer_scale"] = jnp.full_like(
            tree["compress"]["layer_scale"], gamma)
    return cfg, tree, from_jax_params(_np(tree), port_config(cfg))


def _inputs(B=2, S=128, seed=1, packed=False):
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((B, S, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.float32) * 0.75,
                          (B, S)).copy()
    seg = None
    if packed:  # three samples straddling chunks, a padded tail
        seg = np.zeros((B, S), np.int32)
        seg[:, :50], seg[:, 50:90], seg[:, 90:S - 10] = 1, 2, 3
        seg[1, 20:] = seg[1, 20:] * (seg[1, 20:] > 1)
    return embeds, pos, seg


# ---------------------------------------------------------------- helpers


def test_compress_helpers_match_jax():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 40, 8)).astype(np.float32)
    run_parity(lambda x: jcs.compress_avg(x, 8),
               lambda x: tcs.compress_avg(x, 8), h).assert_close(1e-6, 1e-6)
    run_parity(lambda x: jcs.compress_avg(x, 6),
               lambda x: tcs.compress_avg(x, 6), h).assert_close(1e-6, 1e-6)
    qk, qb = rng.standard_normal((8, 5)).astype(np.float32), \
        rng.standard_normal(5).astype(np.float32)
    run_parity(jcs.attention_pooling, tcs.attention_pooling, h, qk,
               qb).assert_close(1e-6, 1e-6)
    # a tie in the scores: equal rows score equally, the earlier one wins
    ht = h.copy()
    ht[:, 7], ht[:, 30] = ht[:, 3], ht[:, 3]
    q1, b1 = rng.standard_normal((8, 1)).astype(np.float32), \
        np.zeros(1, np.float32)
    p = run_parity(lambda x, k, b: jcs.topk_pooling(x, k, b, 9),
                   lambda x, k, b: tcs.topk_pooling(x, k, b, 9), ht, q1, b1)
    p.assert_close(1e-6, 1e-6)
    g = rng.standard_normal((2, 40, 8)).astype(np.float32)
    run_parity(jcs.sigmoid_gate, tcs.sigmoid_gate, h, h[::-1].copy(),
               g).assert_close(1e-6, 1e-6)
    # compress2 at an even bucket: the lower middle position
    pos = rng.permutation(40).astype(np.float32)[None].repeat(2, 0)
    p = run_parity(lambda x, q: jcs.compress2_avg(x, q, 10),
                   lambda x, q: tcs.compress2_avg(x, q, 10), h, pos)
    p.assert_close(1e-6, 0)
    want = torch.tensor(pos[:, :40]).reshape(2, 10, 4).median(dim=2).values
    np.testing.assert_array_equal(p.torch[1], want.numpy())
    p = run_parity(lambda x, q: jcs.compress2_avg(x, q, 100),
                   lambda x, q: tcs.compress2_avg(x, q, 100), h, pos)
    assert p.torch[0].shape == (2, 40, 8)
    p.assert_close(1e-6, 0)


@pytest.mark.parametrize("fuse", ["add", "cross-attn"])
def test_init_compress_params_match_jax(fuse):
    cfg, tree, model = _models(fuse)
    got = tcs.init_compress_params(model.llm, cfg=port_config(cfg).llm,
                                   fuse_method=fuse)
    want = _jax_state_dict(_np(tree), port_config(cfg))
    sd = {"compress." + k: v for k, v in got.state_dict().items()}
    assert set(sd) == {k for k in want if k.startswith("compress.")}
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert got.interaction[0].wqkv.weight.data_ptr() != \
        model.llm.layers[0].wqkv.weight.data_ptr()
    if fuse == "add":  # no cfg needed
        again = tcs.init_compress_params(model.llm)
        for k, v in again.state_dict().items():
            assert torch.equal(v, got.state_dict()[k]), k
    else:
        with pytest.raises(ValueError):
            tcs.init_compress_params(model.llm, fuse_method=fuse)
        wq, wkv = tcs.split_wqkv_for_cross(model.llm.layers[1].wqkv.weight,
                                           port_config(cfg).llm)
        jq, jkv = jcs.split_wqkv_for_cross(
            tree["llm"]["layers"]["wqkv_kernel"][1], cfg.llm)
        np.testing.assert_array_equal(wq.detach().numpy(), np.asarray(jq).T)
        np.testing.assert_array_equal(wkv.detach().numpy(),
                                      np.asarray(jkv).T)


def test_cross_attention_fuse_matches_jax():
    cfg, tree, model = _models("cross-attn", gamma=0.5)
    rng = np.random.default_rng(3)
    xq, xkv = rng.standard_normal((3, 20, 64)).astype(np.float32), \
        rng.standard_normal((3, 7, 64)).astype(np.float32)
    pq, pk = rng.random((3, 20)).astype(np.float32) * 50, \
        rng.random((3, 7)).astype(np.float32) * 50
    fuse = jax.tree.map(lambda a: a[1], tree["compress"]["fuse"])
    run_parity(lambda *a: jcs.cross_attention_fuse(fuse, cfg.llm, *a),
               lambda *a: tcs.cross_attention_fuse(
                   model.compress.fuse[1], port_config(cfg).llm, *a),
               xq, xkv, pq, pk).assert_close(**TOL)


# ---------------------------------------------------------------- forwards


@pytest.mark.parametrize("packed", [False, True], ids=["one_seg", "packed"])
@pytest.mark.parametrize("fuse", ["add", "cross-attn"])
@pytest.mark.parametrize("final_size", [100, 16])
def test_compress_llm_forward_matches_jax(fuse, packed, final_size):
    """fp32 logits within 2e-5; 100 is cut to the 32-token chunks."""
    cfg, tree, model = _models(fuse, gamma=0.5)
    embeds, pos, seg = _inputs(packed=packed)
    want = jcs.compress_llm_forward(
        tree["llm"], tree["compress"], cfg.llm, jnp.asarray(embeds),
        jnp.asarray(pos), 4, final_size=final_size,
        segment_ids=None if seg is None else jnp.asarray(seg),
        attn_impl="jnp", fuse_method=fuse)
    got = tcs.compress_llm_forward(
        model.llm, model.compress, port_config(cfg).llm,
        torch.from_numpy(embeds), torch.from_numpy(pos), 4,
        final_size=final_size,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        fuse_method=fuse)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fuse", ["add", "cross-attn"])
def test_fuse_only_forward_matches_jax(fuse):
    cfg, tree, model = _models(fuse, gamma=0.5)
    embeds, pos, _ = _inputs(S=96)
    kw = dict(final_size=8, fuse_method=fuse)
    want = jcs.compress_fuse_only_forward(
        tree["llm"], tree["compress"], cfg.llm, jnp.asarray(embeds),
        jnp.asarray(pos), 4, attn_impl="jnp", **kw)
    got = tcs.compress_fuse_only_forward(
        model.llm, model.compress, port_config(cfg).llm,
        torch.from_numpy(embeds), torch.from_numpy(pos), 4, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fuse", ["add", "cross-attn"])
def test_compress_gradients_match_jax(fuse):
    """Every leaf of the LLM and the compress parameters, and the inputs'
    gradient, against ``jax.grad`` of the same loss, within LEAF_TOL of
    each leaf's range."""
    cfg, tree, model = _models(fuse, gamma=0.5)
    embeds, pos, seg = _inputs(packed=True)
    w = np.random.default_rng(5).standard_normal((2, 128, 300)).astype(
        np.float32)

    def jloss(p, e):
        lg = jcs.compress_llm_forward(
            p["llm"], p["compress"], cfg.llm, e, jnp.asarray(pos), 4,
            segment_ids=jnp.asarray(seg), attn_impl="jnp", fuse_method=fuse)
        return jnp.mean(lg * w)

    sub = {"llm": tree["llm"], "compress": tree["compress"]}
    gp, ge = jax.grad(jloss, argnums=(0, 1))(sub, jnp.asarray(embeds))
    e = torch.from_numpy(embeds).requires_grad_()
    lg = tcs.compress_llm_forward(
        model.llm, model.compress, port_config(cfg).llm, e,
        torch.from_numpy(pos), 4, segment_ids=torch.from_numpy(seg),
        fuse_method=fuse)
    (lg * torch.from_numpy(w)).mean().backward()
    full = dict(_np(tree), llm=_np(gp["llm"]), compress=_np(gp["compress"]))
    want = _jax_state_dict(full, port_config(cfg))
    named = dict(model.named_parameters())
    checked = 0
    for n, p in named.items():
        if not n.startswith(("llm.", "compress.")):
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        bound = LEAF_TOL * max(np.abs(want[n]).max(), 1e-30)
        err = np.abs(g.double().numpy() - want[n]).max()
        assert err <= bound, f"{n}: {err:.3e} > {bound:.3e}"
        checked += 1
    assert checked == len([n for n in named if n.startswith(
        ("llm.", "compress."))])
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), atol=1e-7,
                               rtol=1e-4)


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("fuse", ["add", "cross-attn"])
def test_compress_train_steps_match_jax(fuse):
    """Two steps of make_train_step through ``internvl_chat.forward``'s
    compress route (AdamW, warmup 1, LayerScale lr scale 2) against JAX's
    step: loss, grad norm and every parameter."""
    cfg = dataclasses.replace(_cfg(fuse), llm=dataclasses.replace(
        _cfg(fuse).llm, hidden_size=32, intermediate_size=64))
    tree = jax_init(jax.random.PRNGKey(0), cfg)
    tree["compress"] = jcs.init_compress_params(tree["llm"], cfg=cfg.llm,
                                                fuse_method=fuse)
    pc = port_config(cfg)
    model = from_jax_params(_np(tree), pc)
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                 layer_scale_lr_scale=2.0)
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), tree)
    jfn = jstep.make_train_step(cfg, tx, None, IMG, attn_impl="jnp",
                                remat=True, donate=False)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), model, pc)
    assert opt.scales["compress.layer_scale"] == 2.0
    assert not opt.decay["compress.layer_scale"]
    tfn = tstep.make_train_step(pc, opt, img_context_token_id=IMG)
    batch = _batch()
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, \
        _torch_batch(batch)
    jstate, tstate = tx.init(tree), opt.init()
    ls0 = model.compress.layer_scale.detach().clone()
    for i in range(2):
        tree, jstate, m = jfn(tree, jstate, jb)
        loss, gnorm = tfn(model, tstate, tb)
        np.testing.assert_allclose(float(loss), float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(gnorm), float(m["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = _jax_state_dict(_np(tree), pc)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)
    assert not torch.equal(model.compress.layer_scale, ls0)


def test_cli_trains_compress_seq(toy_dataset, tmp_path,  # noqa: F811
                                 caplog):
    from v2pe_tpu_torch.core.config import VLMConfig as TVLMConfig
    from v2pe_tpu_torch.train import cli

    tok_dir = str(tmp_path / "tok")
    _toy_tokenizer().save_pretrained(tok_dir)
    argv = ["--model_preset", "debug_tiny", "--tokenizer", tok_dir,
            "--meta_path", toy_dataset, "--output_dir", str(tmp_path / "out"),
            "--max_steps", "2", "--save_steps", "1", "--log_steps", "1",
            "--max_packed_tokens", "1024", "--max_tiles", "4",
            "--max_dynamic_patch", "1", "--warmup_steps", "1",
            "--learning_rate", "1e-3", "--dtype", "float32", "--platform",
            "cpu", "--sync_save", "--compress_seq", "--fuse_method",
            "cross-attn", "--chunk_num", "4"]
    model, _, step = cli.main(argv)
    assert step == 2 and model.compress.fuse[0].wq.weight.shape == (64, 64)
    path = ckpt.latest_checkpoint(str(tmp_path / "out"))
    sd = torch.load(path + "/params.pt")
    assert "compress.layer_scale" in sd and "compress.fuse.1.wkv.weight" in sd
    with open(path + "/config.json") as f:
        saved = TVLMConfig.from_json(f.read())
    assert (saved.compress_seq, saved.fuse_method, saved.chunk_num) == \
        (True, "cross-attn", 4)
    import shutil

    shutil.rmtree(path)
    with caplog.at_level(logging.INFO):
        cli.main(argv)
    assert "resumed from" in caplog.text
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        cli.main(argv + ["--mesh_seq", "2"])


def test_sharded_sequence_raises():
    from v2pe_tpu_torch.parallel import context as pctx

    cfg, tree, model = _models("add")
    embeds, pos, _ = _inputs()
    ctx = pctx.ShardingContext(seq_shards=2)
    with pctx.use_sharding(ctx), pytest.raises(NotImplementedError,
                                               match="Queue 1 item 6"):
        tcs.compress_llm_forward(model.llm, model.compress,
                                 port_config(cfg).llm,
                                 torch.from_numpy(embeds),
                                 torch.from_numpy(pos), 4)
