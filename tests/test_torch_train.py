"""The port's training path against the JAX package's, on the CPU in fp32
with tiny models: the cross-entropies, the loss and every gradient leaf
under each remat mode, three optimizer steps (AdamW, int8 Adam, layer
decay + freeze + accumulation), ``make_train_step``, DropPath semantics on
a given mask, the port's ``train()`` resume and checkpoints, and the CLI.
Weights come from the JAX init (``from_jax_params``); gradients and
moments are compared leaf by leaf through ``_jax_state_dict``."""

import dataclasses
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.data.datasets import build_datasets
from v2pe_tpu.data.packing import PackedSampleIterator
from v2pe_tpu.models import intern_vit as jvit
from v2pe_tpu.models import internvl_chat as jchat
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.core import checkpoint as ckpt
from v2pe_tpu_torch.models import intern_vit as tvit
from v2pe_tpu_torch.models import internlm2 as tlm
from v2pe_tpu_torch.models import internvl_chat as tchat
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params
from v2pe_tpu_torch.train import optimizer as topt
from v2pe_tpu_torch.train import train_step as tstep
from v2pe_tpu_torch.train.trainer import RunConfig, train

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import tokenizer, toy_dataset  # noqa: F401
from .torch_parity import run_parity

IMG = 291  # <IMG_CONTEXT> in the tiny vocab
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4  # of each leaf's range


def _cfg(llm_layers=4, vocab=300):
    return VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=vocab, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=llm_layers, num_attention_heads=4,
                      num_key_value_heads=2),
        rope_pos_id_stride=2)


CFG = _cfg()


def _batch(seed=0):
    """Two packed rows of 96 tokens in the train-step contract: row 0 has
    two segments (the first with a one-tile image) and a padded tail, row 1
    one segment with an image; per-segment positions and V2PE ids, targets
    pre-shifted inside segments, image slots not predicted."""
    rng = np.random.default_rng(seed)
    B, S, nit = 2, 96, CFG.num_image_token
    ids = rng.integers(3, 290, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    seg[0, :40], seg[0, 40:80], seg[1] = 1, 2, 1
    pos = np.zeros((B, S), np.int32)
    pos[0, :40], pos[0, 40:80], pos[1] = np.arange(40), np.arange(40), \
        np.arange(S)
    rope = pos.astype(np.float32)
    gather = np.full((B, S), -1, np.int32)
    for b, at in ((0, 5), (1, 10)):
        ids[b, at:at + nit] = IMG
        rope[b, at:at + nit] = at - 1 + 0.5 * np.arange(1, nit + 1)
        rope[b, at + nit:] -= nit - 0.5 * nit
        gather[b, at:at + nit] = np.arange(nit) + b * nit
    rope[seg == 0] = 1.0
    targets = np.full((B, S), -100, np.int32)
    targets[:, :-1] = ids[:, 1:]
    same = np.zeros((B, S), bool)
    same[:, :-1] = (seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] != 0)
    targets[~same | (ids == IMG)] = -100
    targets[:, :-1][ids[:, 1:] == IMG] = -100
    return {"input_ids": ids, "rope_pos_ids": rope, "token_positions": pos,
            "segment_ids": seg, "targets": targets,
            "loss_weight": (targets != -100).astype(np.float32),
            "pixel_values": rng.standard_normal((2, 3, 56, 56)).astype(
                np.float32),
            "image_flags": np.ones(2, np.int32), "vit_gather_idx": gather}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref():
    """JAX params, batch, loss and gradients (no remat, jnp attention)."""
    params = jax_init(jax.random.PRNGKey(0), CFG)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jstep.loss_fn(p, CFG, jb, IMG, "jnp", False)))(params)
    return params, batch, float(loss), _jax_state_dict(_np(grads), CFG)


def _assert_leaves_close(got: dict, want: dict, tol=LEAF_TOL):
    assert got.keys() == want.keys()
    for n in want:
        w = np.asarray(want[n], np.float64)
        g = got[n].detach().double().numpy() if torch.is_tensor(got[n]) \
            else np.asarray(got[n], np.float64)
        bound = tol * max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= bound, f"{n}: max err {err:.3e} > {bound:.3e}"


# ----------------------------------------------------------------- losses


def test_chunked_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    B, S, D, V = 2, 64, 16, 50
    hidden = rng.standard_normal((B, S, D)).astype(np.float32)
    kernel = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets[rng.random((B, S)) < 0.2] = -100
    w = rng.random((B, S)).astype(np.float32)

    def jax_fn(h, k, t, w):
        f = lambda h, k: jchat.chunked_cross_entropy(h, k, t, w, chunk=16)
        return (f(h, k),) + jax.grad(f, argnums=(0, 1))(h, k)

    def torch_fn(h, k, t, w):
        h, wt = h.requires_grad_(), k.t().contiguous().requires_grad_()
        loss = tchat.chunked_cross_entropy(h, wt, t, w, chunk=16)
        loss.backward()
        return loss, h.grad, wt.grad.t()

    run_parity(jax_fn, torch_fn, hidden, kernel, targets, w).assert_close(
        atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_losses_match_jax(weighted):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 24, 30)).astype(np.float32)
    labels = rng.integers(0, 30, (2, 24)).astype(np.int32)
    labels[:, :3] = -100
    w = rng.random((2, 24)).astype(np.float32)

    def fns(lib):
        def fn(lg, lb, w):
            w = w if weighted else None
            return (lib.cross_entropy_loss(lg, lb, w),
                    lib.cross_entropy_loss_preshifted(lg, lb, w))
        return fn

    run_parity(fns(jchat), fns(tchat), logits, labels, w).assert_close(
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("remat", ["none", "full", "block2", "block4",
                                   "attn_saved"])
def test_loss_and_grads_match_jax(ref, remat):
    params, batch, loss_j, grads_j = ref
    model = from_jax_params(_np(params), CFG)
    loss = tstep.loss_fn(model, CFG, _torch_batch(batch), IMG, remat=remat)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=LOSS_RTOL)
    _assert_leaves_close({n: p.grad for n, p in model.named_parameters()},
                         grads_j)


@pytest.mark.parametrize("mode,layers,want", [
    ("full", 4, 4), ("block2", 4, 2), ("block4", 4, 1), ("block2", 3, 3),
    ("block4", 3, 3), ("attn_saved", 3, 3), ("none", 3, 0)])
def test_remat_checkpoints_blocks_or_falls_back(monkeypatch, mode, layers,
                                                want):
    """The checkpoint count of each mode: per layer, per block, per layer
    again when the block does not divide the depth (JAX's fallback), the
    MLP blocks for attn_saved, none without remat."""
    calls = []
    real = tlm._checkpoint
    monkeypatch.setattr(tlm, "_checkpoint",
                        lambda fn, *a: calls.append(fn) or real(fn, *a))
    cfg = _cfg(layers).llm
    model = tlm.InternLM2Model(cfg)
    ids = torch.randint(0, 300, (1, 24))
    out, _ = tlm.llm_forward(model, cfg, input_ids=ids,
                             segment_ids=torch.ones(1, 24, dtype=torch.int32),
                             remat=mode)
    out.sum().backward()
    assert len(calls) == want


# -------------------------------------------------------------- DropPath


def test_drop_path_matches_jax_on_its_mask():
    """The port's drop_path on the Bernoulli mask that JAX's drop_path
    draws from its key: the same per-sample keep / zero and 1/keep
    scaling."""
    x = np.random.default_rng(3).standard_normal((6, 5, 8)).astype(
        np.float32)
    rate = np.float32(0.4)
    key = jax.random.PRNGKey(7)
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (6, 1, 1)))
    assert 0 < mask.sum() < 6
    want = np.asarray(jvit.drop_path(jnp.asarray(x), rate, key))
    got = tvit.drop_path(torch.from_numpy(x), torch.tensor(1.0 - rate),
                         torch.from_numpy(mask.reshape(6).copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_drop_path_schedule_and_layer_match_jax():
    """linspace(0, rate, L) keep probabilities, and a whole ViT layer with
    DropPath on both branches, each on the masks JAX draws."""
    cfg = dataclasses.replace(CFG.vision, drop_path_rate=0.3)
    params = jax_init(jax.random.PRNGKey(1), dataclasses.replace(
        CFG, vision=cfg))
    model = from_jax_params(_np(params), dataclasses.replace(CFG, vision=cfg))
    keep, masks = tvit.drop_path_masks(cfg, 2, 3, torch.Generator())
    np.testing.assert_allclose(
        keep.numpy(), 1.0 - np.asarray(jnp.linspace(0.0, 0.3, 2)), rtol=1e-7)
    assert masks.shape == (2, 2, 3) and masks.dtype == torch.bool

    x = np.random.default_rng(4).standard_normal((3, 17, 32)).astype(
        np.float32)
    layer = jax.tree.map(lambda a: a[1], params["vision"]["layers"])
    rate = jnp.linspace(0.0, 0.3, 2)[1]
    keys = (jax.random.PRNGKey(5), jax.random.PRNGKey(6))
    want = jvit.layer_forward(layer, cfg, jnp.asarray(x), "jnp", rate, keys)
    m = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
        k, 1.0 - rate, (3, 1, 1))).reshape(3) for k in keys]))
    with torch.no_grad():
        got = tvit.layer_forward(model.vision.layers[1], cfg,
                                 torch.from_numpy(x),
                                 torch.tensor(1.0 - np.asarray(rate)), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_drop_path_masks_survive_remat():
    """Under remat the recomputed layer must see the same masks: the
    gradient with remat equals the gradient without."""
    cfg = dataclasses.replace(CFG.vision, drop_path_rate=0.5)
    vlm = dataclasses.replace(CFG, vision=cfg)
    model = from_jax_params(_np(jax_init(jax.random.PRNGKey(2), vlm)), vlm)
    pix = torch.from_numpy(_batch()["pixel_values"])
    grads = []
    for remat in (False, True):
        model.zero_grad()
        out = tvit.vision_forward(
            model.vision, cfg, pix, remat=remat,
            drop_path_generator=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        grads.append(model.vision.layers[0].fc1.weight.grad.clone())
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


# ------------------------------------------------------------- optimizer


def _opt_state_moments(state):
    """(mu, nu) trees of the Adam state inside an optax chain state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state.mu, state.nu
    if isinstance(state, tuple):
        for s in state:
            found = _opt_state_moments(s)
            if found is not None:
                return found
    return None


OPT_CASES = {
    "adamw": (dict(), 3),
    "int8": (dict(use_8bit_optimizer=True), 3),
    "decay_freeze_accum": (dict(vit_layer_decay_rate=0.8,
                                llm_layer_decay_rate=0.9, vit_lr_scale=0.5,
                                layer_scale_lr_scale=2.0, freeze_mlp=True,
                                grad_accum_steps=2), 4),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_steps_match_optax(case):
    """The same gradients through optax's chain and the port's, step by
    step: parameters and moments within 1e-6, int8 codes equal and scales
    within a few fp32 ulps. The warmup makes step 1 a zero update."""
    over, steps = OPT_CASES[case]
    int8 = case == "int8"
    # int8: gradients small enough that the clip stays off, so that the
    # two sums of squares in other orders cannot move a rounding boundary
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, **over)
    cfg = _cfg(llm_layers=2)
    params = jax_init(jax.random.PRNGKey(3), cfg)
    model = from_jax_params(_np(params), cfg)
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), params)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), model, cfg)
    jstate, tstate = tx.init(params), opt.init()
    rng = np.random.default_rng(4)
    scale = 1e-5 if int8 else 1e-2
    update = jax.jit(tx.update)
    for _ in range(steps):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale
                                        ).astype(np.float32), _np(params))
        upd, jstate = update(grads, jstate, params)
        params = optax.apply_updates(params, upd)
        opt.step({n: torch.from_numpy(np.array(g)) for n, g in
                  _jax_state_dict(grads, cfg).items()}, tstate)
    want = _jax_state_dict(_np(params), cfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6,
                                   rtol=0, err_msg=n)
    mu, nu = _opt_state_moments(jstate)
    if not int8:
        for tree, got in ((mu, tstate["mu"]), (nu, tstate["nu"])):
            want = _jax_state_dict(_np(tree), cfg)
            for n in want:
                np.testing.assert_allclose(got[n].numpy(), want[n],
                                           atol=1e-6, rtol=0, err_msg=n)
        return
    for key, mom in tstate["moments"].items():
        node_m, node_v = mu, nu
        for k in key.split("/"):
            node_m, node_v = node_m[k], node_v[k]
        for q, tag in ((node_m, "m"), (node_v, "v")):
            np.testing.assert_array_equal(
                mom[f"{tag}_code"].numpy(), np.asarray(q.code).reshape(-1),
                err_msg=f"{key} {tag} codes")
            # XLA fuses b2*v + (1-b2)*g*g into a fused multiply-add, which
            # moves a block's absmax by a few fp32 ulps
            np.testing.assert_allclose(
                mom[f"{tag}_scale"].numpy(), np.asarray(q.scale), rtol=5e-7,
                atol=0, err_msg=f"{key} {tag} scales")


def test_lr_schedule_matches_optax():
    for kw in (dict(warmup_steps=3, total_steps=10),
               dict(warmup_steps=0, total_steps=5, min_lr_ratio=0.1),
               dict(warmup_steps=4, total_steps=2)):
        want = jopt.lr_schedule(jopt.TrainConfig(learning_rate=2e-3, **kw))
        got = topt.lr_schedule(topt.TrainConfig(learning_rate=2e-3, **kw))
        for c in range(12):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                       atol=1e-12)


def test_make_train_step_three_steps_match_jax(ref):
    """Loss and grad norm of three steps of make_train_step (remat 'full',
    AdamW, warmup 1) against JAX's step on the same batch."""
    params, batch, _, _ = ref
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    model = from_jax_params(_np(params), CFG)
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), params)
    jfn = jstep.make_train_step(CFG, tx, None, IMG, attn_impl="jnp",
                                remat=True, donate=False)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), model, CFG)
    tfn = tstep.make_train_step(CFG, opt, img_context_token_id=IMG)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, \
        _torch_batch(batch)
    jstate, tstate = tx.init(params), opt.init()
    for i in range(3):
        params, jstate, m = jfn(params, jstate, jb)
        loss, gnorm = tfn(model, tstate, tb)
        np.testing.assert_allclose(float(loss), float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(gnorm), float(m["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = _jax_state_dict(_np(params), CFG)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_bench_recipe_steps_match_jax():
    """The bench recipe (``bench.py:299-334``) at a tiny width: the port's
    make_synthetic_batch gives JAX's batch, and three steps of
    make_train_step on it (remat 'full', int8 Adam, lr 1e-5, warmup 1)
    give JAX's loss, grad norm and parameters."""
    from v2pe_tpu.train import synth as jsynth
    from v2pe_tpu_torch.train import synth as tsynth

    cfg = _cfg(llm_layers=2, vocab=92553)
    kw = dict(tiles_per_row=2, stride=64)
    batch = tsynth.make_synthetic_batch(cfg, 1, 128, **kw)
    want = jsynth.make_synthetic_batch(cfg, 1, 128, **kw)
    assert batch.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    tc_kw = dict(learning_rate=1e-5, warmup_steps=1, total_steps=100,
                 use_8bit_optimizer=True)
    params = jax_init(jax.random.PRNGKey(5), cfg)
    model = from_jax_params(_np(params), cfg)
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), params)
    jfn = jstep.make_train_step(cfg, tx, None, jsynth.IMG_CONTEXT_ID,
                                attn_impl="jnp", remat="full", donate=False)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), model, cfg)
    tfn = tstep.make_train_step(cfg, opt,
                                img_context_token_id=tsynth.IMG_CONTEXT_ID,
                                remat="full")
    jb, tb = {k: jnp.asarray(v) for k, v in want.items()}, \
        _torch_batch(batch)
    jstate, tstate = tx.init(params), opt.init()
    for i in range(3):
        params, jstate, m = jfn(params, jstate, jb)
        loss, gnorm = tfn(model, tstate, tb)
        np.testing.assert_allclose(float(loss), float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(gnorm), float(m["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = _jax_state_dict(_np(params), cfg)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)


def test_unported_options_raise():
    cfg = _cfg(1)
    model = from_jax_params(_np(jax_init(jax.random.PRNGKey(0), cfg)), cfg)
    opt = topt.build_optimizer(topt.TrainConfig(), model, cfg)
    for kw in (dict(mesh=object()), dict(lora=True),
               dict(pipe_microbatches=2), dict(ring_mode="fused"),
               dict(offload_optimizer=True)):
        with pytest.raises(NotImplementedError):
            tstep.make_train_step(cfg, opt, **kw)
    with pytest.raises(NotImplementedError):
        topt.build_optimizer(topt.TrainConfig(use_8bit_optimizer=True,
                                              offload_optimizer=True),
                             model, cfg)


# ------------------------------------------------- trainer, checkpoints


def _toy_run(toy_dataset, tokenizer, out_dir, resume, max_steps=4):
    cfg = _cfg(llm_layers=2, vocab=len(tokenizer))
    ctx = tokenizer.convert_tokens_to_ids("<IMG_CONTEXT>")
    dsets = build_datasets(toy_dataset, tokenizer, image_size=56,
                           num_image_token=4, max_dynamic_patch=6,
                           rope_pos_id_stride=2)
    packer = PackedSampleIterator(dsets, max_tokens=192, max_tiles_per_row=8,
                                  seed=5, img_context_token_id=ctx)
    run = RunConfig(output_dir=str(out_dir), max_steps=max_steps,
                    save_steps=2, save_total_limit=2, log_steps=1,
                    max_packed_tokens=192, max_tiles=8)
    tc = topt.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                          use_8bit_optimizer=True)
    model = from_jax_params(_np(jax_init(jax.random.PRNGKey(0), cfg)), cfg)
    logged = []
    model, state, step = train(
        cfg, model, packer, run, tc, img_context_token_id=ctx,
        resume=resume, metrics_hook=lambda s, m: logged.append((s, m)))
    return model, state, logged


def test_train_resume_equals_uninterrupted(toy_dataset, tokenizer,
                                           tmp_path, caplog):
    m1, s1, log1 = _toy_run(toy_dataset, tokenizer, tmp_path / "out", False)
    assert ckpt.list_checkpoints(str(tmp_path / "out")) == [2, 4]
    assert [s for s, _ in log1] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for _, m in log1)
    shutil.rmtree(tmp_path / "out" / "step_00000004")
    with caplog.at_level(logging.INFO):
        m2, s2, log2 = _toy_run(toy_dataset, tokenizer, tmp_path / "out",
                                True)
    assert "resumed from" in caplog.text
    assert [s for s, _ in log2] == [3, 4]
    assert [m["loss"] for _, m in log2] == [m["loss"] for _, m in log1[2:]]
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    for key, mom in s1["moments"].items():
        for part, t in mom.items():
            torch.testing.assert_close(t, s2["moments"][key][part], rtol=0,
                                       atol=0)


def test_prefetcher_keeps_batches_a_slow_consumer_has_not_taken(
        monkeypatch):
    """A step slower than the put timeout must not lose the waiting batch:
    the consumer sees every batch in order."""
    import time

    from v2pe_tpu_torch.train.trainer import Prefetcher

    monkeypatch.setattr(Prefetcher, "poll_s", 0.01)
    made = iter(range(100))
    pf = Prefetcher(lambda: next(made), depth=1)
    try:
        got = []
        for _ in range(4):
            time.sleep(0.1)  # ten timeouts of the waiting put
            got.append(pf.next())
    finally:
        pf.stop(timeout=5)
    assert got == [0, 1, 2, 3]
    assert not pf.thread.is_alive()


def test_async_saver_commit_semantics(tmp_path):
    cfg = _cfg(llm_layers=1)
    model = from_jax_params(_np(jax_init(jax.random.PRNGKey(2), cfg)), cfg)
    opt = topt.build_optimizer(topt.TrainConfig(), model, cfg)
    state = opt.init()
    saver = ckpt.AsyncSaver()
    try:
        path1 = saver.save(str(tmp_path), 1, model, state,
                           data_state={"cursors": {"a": 1}},
                           save_total_limit=2, cfg=cfg)
        assert not os.path.exists(os.path.join(path1, "meta.json"))
        assert ckpt.latest_checkpoint(str(tmp_path)) is None
        with torch.no_grad():  # the snapshot was taken at save()
            next(model.parameters()).add_(1.0)
        assert saver.finalize() == path1
        assert ckpt.latest_checkpoint(str(tmp_path)) == path1
        fresh = from_jax_params(_np(jax_init(jax.random.PRNGKey(2), cfg)),
                                cfg)
        back, st, step, ds = ckpt.restore_checkpoint(path1, fresh,
                                                     opt.init())
        assert step == 1 and ds["cursors"] == {"a": 1}
        assert st["count"] == 0
        want = from_jax_params(_np(jax_init(jax.random.PRNGKey(2), cfg)),
                               cfg)
        for a, b in zip(back.parameters(), want.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        with open(os.path.join(path1, "config.json")) as f:
            assert VLMConfig.from_json(f.read()) == cfg
        saver.save(str(tmp_path), 2, model, state, save_total_limit=2)
        saver.save(str(tmp_path), 3, model, state, save_total_limit=2)
        assert ckpt.list_checkpoints(str(tmp_path)) == [1, 2]
    finally:
        saver.close()
    assert ckpt.list_checkpoints(str(tmp_path)) == [2, 3]


def test_cli_trains_and_resumes(toy_dataset, tmp_path, caplog):
    from v2pe_tpu_torch.train import cli

    tok_dir = str(tmp_path / "tok")
    _toy_tokenizer().save_pretrained(tok_dir)
    argv = ["--model_preset", "debug_tiny", "--tokenizer", tok_dir,
            "--meta_path", toy_dataset, "--output_dir",
            str(tmp_path / "out"), "--max_steps", "2", "--save_steps", "1",
            "--log_steps", "1", "--max_packed_tokens", "1024",
            "--max_tiles", "4", "--max_dynamic_patch", "1",
            "--warmup_steps", "1", "--learning_rate", "1e-3",
            "--dtype", "float32", "--platform", "cpu", "--sync_save"]
    model, _, step = cli.main(argv)
    assert step == 2
    assert ckpt.list_checkpoints(str(tmp_path / "out")) == [1, 2]
    with open(tmp_path / "out" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
    shutil.rmtree(tmp_path / "out" / "step_00000002")
    with caplog.at_level(logging.INFO):
        cli.main(argv)
    assert "resumed from" in caplog.text
    for bad in (["--mesh_seq", "2"], ["--use_llm_lora", "4"],
                ["--compress_seq"], ["--offload_optimizer"],
                ["--llm_arch", "qwen2"], ["--model_name_or_path", "ckpt"]):
        with pytest.raises(NotImplementedError):
            cli.main(argv + bad)
