"""LoRA in the port (``models/lora.py`` and its uses in the train step,
the trainer, the CLI, ChatModel, the export and the export tool) against
the JAX package's LoRA on the CPU, fp32, tiny models: the adapters' targets,
shapes and alpha; the merge (fp32 within 1e-6, bf16 equal to JAX's
rounding); forwards on merged weights; three LoRA train steps (AdamW and
int8 Adam) with the base weights unchanged; the freeze flags' effect on
adapters, pinned to what JAX does; adapter-only checkpoints and resume;
greedy chat and the export with ``lora=``."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.models import internlm2 as jlm
from v2pe_tpu.models import lora as jlora
from v2pe_tpu.models.export import export_torch_state_dict as jax_export
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.core import checkpoint as ckpt
from v2pe_tpu_torch.data.datasets import build_datasets
from v2pe_tpu_torch.data.packing import PackedSampleIterator
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig
from v2pe_tpu_torch.models import internlm2 as tlm
from v2pe_tpu_torch.models import lora as tlora
from v2pe_tpu_torch.models.export import (export_torch_state_dict,
                                          save_safetensors)
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params
from v2pe_tpu_torch.train import optimizer as topt
from v2pe_tpu_torch.train import train_step as tstep
from v2pe_tpu_torch.train.trainer import RunConfig, train

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import tokenizer, toy_dataset  # noqa: F401
from .test_torch_train import (IMG, LEAF_TOL, LOSS_RTOL, _batch, _cfg, _np,
                               _opt_state_moments, _torch_batch)
from .torch_parity import port_config

CFG = _cfg(llm_layers=2)


def _jax_adapters(cfg, seed=1, backbone_r=2, llm_r=4, b_scale=0.05):
    """JAX adapters of both towers with a seeded nonzero ``b`` (a fresh
    ``b`` is 0, which makes the merge the identity)."""
    params = jax_init(jax.random.PRNGKey(0), cfg)
    ad = jlora.build_lora(jax.random.PRNGKey(seed), params,
                          backbone_r=backbone_r, llm_r=llm_r)
    rng = np.random.default_rng(seed)
    ad = jax.tree_util.tree_map_with_path(
        lambda p, x: x + b_scale * rng.standard_normal(x.shape).astype(
            np.float32) if str(getattr(p[-1], "key", "")) == "b" else x, ad,
        is_leaf=lambda x: x is None)
    return params, ad


def _lora_state(tree, lora: tlora.LoRA) -> dict:
    """A JAX adapter tree (or its gradients / moments) under the port's
    adapter names and layouts."""
    out = {}
    for name, (path, layer, transposed) in tlora.lora_leaf_map(lora).items():
        a = tree
        for k in path:
            a = a[k]
        a = np.asarray(a)
        if layer is not None:
            a = a[layer]
        out[name] = a.T if transposed else a
    return out


def _assert_state_close(got: dict, want: dict, tol=LEAF_TOL):
    assert set(got) == set(want)
    for n in want:
        w = np.asarray(want[n], np.float64)
        g = got[n].detach().double().cpu().numpy()
        bound = tol * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= bound, (n, np.abs(g - w).max(), bound)


def _same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -------------------------------------------------------------- adapters


def test_init_targets_shapes_and_alpha_match_jax():
    params = jax_init(jax.random.PRNGKey(0), CFG)
    model = from_jax_params(_np(params), port_config(CFG))
    want = jlora.build_lora(jax.random.PRNGKey(1), params, backbone_r=2,
                            llm_r=4)
    got = tlora.build_lora(torch.Generator().manual_seed(1), model,
                           backbone_r=2, llm_r=4)
    names = sorted(got.targets())
    assert names == sorted(
        f"{t}.layers.{i}.{k}" for t, n, ks in
        (("vision", 2, ("qkv", "proj")),
         ("llm", 2, ("wqkv", "wo", "w1", "w2", "w3")))
        for i in range(n) for k in ks)
    ref = _lora_state(_np(want), got)
    for n, t in got.state_dict().items():
        assert t.dtype == torch.float32
        assert tuple(t.shape) == ref[n].shape, n
        if n.endswith(".alpha"):
            assert float(t) == float(ref[n]) == (
                4.0 if n.startswith("vision") else 8.0), n
        if n.endswith(".B"):
            assert not t.any()
        if n.endswith(".A"):
            assert 0.005 < float(t.std()) < 0.02
    # the adapter leaves of JAX's tree are exactly the port's
    leaves = {"/".join(p[:-1]) for p, _, _ in
              tlora.lora_leaf_map(got).values()}
    jleaves = {"/".join(str(k.key) for k in p[:-1])
               for p, _ in jax.tree_util.tree_leaves_with_path(want)}
    assert leaves == jleaves
    mask = tlora.lora_trainable_mask(model, got)
    jmask = jlora.lora_trainable_mask(params, want)
    from v2pe_tpu_torch.models.params import jax_leaf_map

    for n, leaf in jax_leaf_map(port_config(CFG)).items():
        node = jmask
        for k in leaf.path:
            node = node[k]
        assert mask[n] == bool(node), n
    assert tlora.build_lora(torch.Generator(), model) is None
    with pytest.raises(ValueError, match="overlapping"):
        tlora.combine_lora(got, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_jax(dtype):
    """fp32: within 1e-6 of JAX's merge; bf16 weights: the fp32 sum rounds
    to JAX's bf16 bits. The caller's model is left as it was."""
    params, ad = _jax_adapters(CFG)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = jax.tree.map(lambda a: a.astype(jdt), params)
    tdt = getattr(torch, dtype)
    model = from_jax_params(_np(params), port_config(CFG), dtype=tdt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lora = tlora.from_jax_lora(_np(ad), port_config(CFG))
    merged = tlora.merge_lora(model, lora)
    want = _jax_state_dict(_np(jax.tree.map(
        lambda a: a.astype(jnp.float32), jlora.merge_lora(params, ad))),
        port_config(CFG))
    got = merged.state_dict()
    for n in want:
        g = got[n].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, want[n], atol=1e-6, rtol=0,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(g, want[n], err_msg=n)
    _same_bits(model.state_dict(), before)
    # only the targets' weights are new tensors
    targets = {n + ".weight" for n in lora.targets()}
    for (n, a), b in zip(model.named_parameters(), merged.parameters()):
        assert (a is b) == (n not in targets), n


def test_forward_on_merged_weights_matches_jax():
    params, ad = _jax_adapters(CFG)
    model = from_jax_params(_np(params), port_config(CFG))
    merged = tlora.merge_lora(model, tlora.from_jax_lora(_np(ad)))
    ids = np.random.default_rng(2).integers(0, 300, (2, 24)).astype(np.int32)
    want, _ = jlm.llm_forward(jlora.merge_lora(params, ad)["llm"], CFG.llm,
                              input_ids=jnp.asarray(ids), attn_impl="jnp")
    got, _ = tlm.llm_forward(merged.llm, port_config(CFG).llm,
                             input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    plain, _ = tlm.llm_forward(model.llm, port_config(CFG).llm,
                               input_ids=torch.from_numpy(ids))
    assert not np.allclose(plain.detach().numpy(), np.asarray(want),
                           atol=1e-3)


# -------------------------------------------------------------- training


def _steps(tc_kw, steps=3, llm_r=4, backbone_r=2):
    """``steps`` LoRA train steps of JAX and the port on the same weights,
    adapters and batch: per step (JAX metrics, port loss, port grad norm,
    JAX adapters under the port's names, the port's adapters), plus the
    port's adapters, its base model and the base's state before the
    steps."""
    params, ad = _jax_adapters(CFG, backbone_r=backbone_r, llm_r=llm_r)
    pc = port_config(CFG)
    model = from_jax_params(_np(params), pc)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lora = tlora.from_jax_lora(_np(ad))
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), ad)
    jfn = jstep.make_train_step(CFG, tx, None, IMG, attn_impl="jnp",
                                remat=True, donate=False, lora=True)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), lora, pc)
    tfn = tstep.make_train_step(pc, opt, img_context_token_id=IMG,
                                lora=True)
    batch = _batch()
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, \
        _torch_batch(batch)
    jstate, tstate = tx.init(ad), opt.init()
    out = []
    for _ in range(steps):
        ad, jstate, m = jfn(ad, jstate, jb, params)
        loss, gnorm = tfn(lora, tstate, tb, model)
        out.append((m, loss, gnorm, _lora_state(_np(ad), lora),
                    {k: v.clone() for k, v in lora.state_dict().items()}))
    return out, lora, model, before


@pytest.mark.parametrize("int8", [False, True], ids=["adamw", "int8"])
def test_lora_train_steps_match_jax(int8):
    """Loss, grad norm and every adapter tensor after each of three steps
    against JAX's LoRA step; the base model bit for bit unchanged; alpha
    fixed; A and B moved."""
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                 use_8bit_optimizer=int8)
    lora0 = tlora.from_jax_lora(_np(_jax_adapters(CFG)[1]))
    steps, lora, model, before = _steps(tc_kw)
    for i, (m, loss, gnorm, want, got) in enumerate(steps):
        np.testing.assert_allclose(float(loss), float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(gnorm), float(m["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        _assert_state_close(got, want)
    _same_bits(model.state_dict(), before)
    assert all(p.requires_grad for p in model.parameters())
    start, end = lora0.state_dict(), lora.state_dict()
    for n in end:
        moved = not torch.equal(start[n], end[n])
        assert moved == (not n.endswith(".alpha")), n


def test_freeze_llm_zeroes_the_llm_adapters_as_jax_does():
    """JAX's freeze mask is decided on the adapter paths too: under
    ``freeze_llm`` the LLM's adapters get zero updates and the backbone's
    train. (The reference freezes, then wraps with peft, which would train
    the LLM's adapters: see ROADMAP Queue 3.)"""
    tc_kw = dict(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                 freeze_llm=True)
    lora0 = tlora.from_jax_lora(_np(_jax_adapters(CFG)[1])).state_dict()
    steps, lora, _, _ = _steps(tc_kw, steps=2)
    want = steps[-1][3]
    for _, _, _, w, got in steps:
        _assert_state_close(got, w)
    for n, t in lora.state_dict().items():
        frozen = n.startswith("llm.")
        assert torch.equal(t, lora0[n]) == (frozen or n.endswith(".alpha"))
        assert np.array_equal(want[n], lora0[n].numpy()) == \
            (frozen or n.endswith(".alpha"))


ADAPTER_OPT_CASES = {
    "adamw": dict(),
    "int8": dict(use_8bit_optimizer=True),
    "decay_freeze_scales": dict(vit_layer_decay_rate=0.8,
                                llm_layer_decay_rate=0.9, vit_lr_scale=0.5,
                                freeze_backbone=True, unfreeze_vit_layers=-1),
}


@pytest.mark.parametrize("case", list(ADAPTER_OPT_CASES))
def test_optimizer_on_adapters_matches_optax(case):
    """The same gradients through optax's chain over JAX's adapter tree and
    the port's optimizer over the adapters: every mask and scale decided
    on the adapter paths and their stacked ndim (layer decay on
    ``.../a``, the freeze flags with their carve-outs), adapters within
    1e-6 after three steps, int8 codes equal and scales within a few fp32
    ulps on the stacked adapter leaves."""
    tc_kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                 **ADAPTER_OPT_CASES[case])
    _, ad = _jax_adapters(CFG)
    lora = tlora.from_jax_lora(_np(ad))
    tx = jopt.build_optimizer(jopt.TrainConfig(**tc_kw), ad)
    opt = topt.build_optimizer(topt.TrainConfig(**tc_kw), lora,
                               port_config(CFG))
    jstate, tstate = tx.init(ad), opt.init()
    rng = np.random.default_rng(4)
    update = jax.jit(tx.update)
    for _ in range(3):  # small gradients: the clip stays off
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-5
                                        ).astype(np.float32), _np(ad))
        grads = jax.tree_util.tree_map_with_path(
            lambda p, g: g * 0 if p[-1].key == "alpha" else g, grads)
        upd, jstate = update(grads, jstate, ad)
        ad = jax.tree.map(lambda a, u: a + u, ad, upd)
        g = _lora_state(grads, lora)
        opt.step({n: torch.from_numpy(np.ascontiguousarray(g[n]))
                  for n, _ in lora.named_parameters()}, tstate)
    want = _lora_state(_np(ad), lora)
    for n, t in lora.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[n], atol=1e-6, rtol=0,
                                   err_msg=n)
    if not tc_kw.get("use_8bit_optimizer"):
        return
    mu, nu = _opt_state_moments(jstate)
    assert set(tstate["moments"]) == {
        "/".join(p) for p, _, _ in tlora.lora_leaf_map(lora).values()
        if p[-1] != "alpha"}
    for key, mom in tstate["moments"].items():
        node_m, node_v = mu, nu
        for k in key.split("/"):
            node_m, node_v = node_m[k], node_v[k]
        for q, tag in ((node_m, "m"), (node_v, "v")):
            np.testing.assert_array_equal(
                mom[f"{tag}_code"].numpy(), np.asarray(q.code).reshape(-1),
                err_msg=f"{key} {tag} codes")
            np.testing.assert_allclose(
                mom[f"{tag}_scale"].numpy(), np.asarray(q.scale), rtol=5e-7,
                atol=0, err_msg=f"{key} {tag} scales")


def _toy_lora_run(toy_dataset, tokenizer, out_dir, resume,  # noqa: F811
                  base_seed=0):
    cfg = _cfg(llm_layers=2, vocab=len(tokenizer))
    ctx = tokenizer.convert_tokens_to_ids("<IMG_CONTEXT>")
    dsets = build_datasets(toy_dataset, tokenizer, image_size=56,
                           num_image_token=4, max_dynamic_patch=6,
                           rope_pos_id_stride=2)
    packer = PackedSampleIterator(dsets, max_tokens=192, max_tiles_per_row=8,
                                  seed=5, img_context_token_id=ctx)
    run = RunConfig(output_dir=str(out_dir), max_steps=4, save_steps=2,
                    save_total_limit=2, log_steps=1, max_packed_tokens=192,
                    max_tiles=8)
    tc = topt.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                          use_8bit_optimizer=True)
    model = from_jax_params(_np(jax_init(jax.random.PRNGKey(base_seed),
                                         cfg)), port_config(cfg))
    logged = []
    merged, state, _ = train(
        port_config(cfg), model, packer, run, tc, img_context_token_id=ctx,
        resume=resume, use_llm_lora=4, use_backbone_lora=2,
        metrics_hook=lambda s, m: logged.append((s, m)))
    return model, merged, state, logged


def test_train_lora_saves_adapters_only_and_resumes(toy_dataset, tokenizer,
                                                    tmp_path):  # noqa: F811
    base = from_jax_params(_np(jax_init(jax.random.PRNGKey(0), _cfg(
        llm_layers=2, vocab=len(tokenizer)))), port_config(_cfg(
            llm_layers=2, vocab=len(tokenizer))))
    out = tmp_path / "out"
    m1, merged1, s1, log1 = _toy_lora_run(toy_dataset, tokenizer, out, False)
    assert ckpt.list_checkpoints(str(out)) == [2, 4]
    _same_bits(m1.state_dict(), base.state_dict())  # the base is untouched
    sd = torch.load(out / "step_00000004" / "params.pt")
    assert sd and all(k.endswith((".A", ".B", ".alpha")) for k in sd)
    assert {k.rsplit(".", 1)[0] for k in sd} == set(
        tlora.build_lora(torch.Generator(), m1, 2, 4).targets())
    lora = tlora.lora_from_state_dict(sd)
    _same_bits(merged1.state_dict(),
               tlora.merge_lora(m1, lora).state_dict())
    shutil.rmtree(out / "step_00000004")
    _, merged2, s2, log2 = _toy_lora_run(toy_dataset, tokenizer, out, True)
    assert [s for s, _ in log2] == [3, 4]
    assert [m["loss"] for _, m in log2] == [m["loss"] for _, m in log1[2:]]
    _same_bits(merged2.state_dict(), merged1.state_dict())
    for key, mom in s1["moments"].items():
        for part, t in mom.items():
            assert torch.equal(t, s2["moments"][key][part]), (key, part)


def test_cli_trains_lora(toy_dataset, tmp_path):  # noqa: F811
    from v2pe_tpu_torch.train import cli

    tok_dir = str(tmp_path / "tok")
    _toy_tokenizer().save_pretrained(tok_dir)
    merged, _, step = cli.main([
        "--model_preset", "debug_tiny", "--tokenizer", tok_dir,
        "--meta_path", toy_dataset, "--output_dir", str(tmp_path / "out"),
        "--max_steps", "2", "--save_steps", "1", "--log_steps", "1",
        "--max_packed_tokens", "1024", "--max_tiles", "4",
        "--max_dynamic_patch", "1", "--warmup_steps", "1",
        "--learning_rate", "1e-3", "--dtype", "float32", "--platform",
        "cpu", "--sync_save", "--use_llm_lora", "4",
        "--use_backbone_lora", "2"])
    assert step == 2
    sd = torch.load(tmp_path / "out" / "step_00000002" / "params.pt")
    ranks = {k.rsplit(".", 2)[0].split(".")[0]: v.shape[0]
             for k, v in sd.items() if k.endswith(".A")}
    assert ranks == {"vision": 2, "llm": 4}
    assert all(torch.isfinite(p).all() for p in merged.parameters())


# ------------------------------------------------------ serving, export


def test_chat_model_lora_greedy_matches_jax():
    """ChatModel(lora=...) gives JAX's greedy tokens, and leaves the
    caller's model as it was; merge before int8 quantization equals
    quantizing the merged model."""
    from .test_torch_chat import _cfg as chat_cfg

    tok = _toy_tokenizer()
    cfg = chat_cfg(vocab=len(tok))
    params, ad = _jax_adapters(cfg, b_scale=0.5)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    pc = port_config(cfg)
    model = from_jax_params(_np(params), pc)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    lora = tlora.from_jax_lora(_np(ad))
    q = "What is 2 plus 2?"
    want = JaxChatModel(params, cfg, tok, attn_impl="jnp", lora=ad).chat(
        None, q, JaxGenerationConfig(max_new_tokens=6))
    got = ChatModel(model, pc, tok, lora=lora).chat(
        None, q, GenerationConfig(max_new_tokens=6))
    assert got == want
    back = tlora.lora_from_state_dict(lora.state_dict())
    assert ChatModel(model, pc, tok, lora=back).chat(
        None, q, GenerationConfig(max_new_tokens=6)) == want
    plain = ChatModel(model, pc, tok).chat(None, q,
                                           GenerationConfig(max_new_tokens=6))
    assert plain != want
    _same_bits(model.state_dict(), before)
    merged = tlora.merge_lora(model, lora)
    gc = GenerationConfig(max_new_tokens=4)
    assert ChatModel(model, pc, tok, lora=lora, weights_dtype="int8").chat(
        None, q, gc) == ChatModel(merged, pc, tok,
                                  weights_dtype="int8").chat(None, q, gc)


def test_export_with_lora_matches_jax():
    params, ad = _jax_adapters(CFG)
    pc = port_config(CFG)
    model = from_jax_params(_np(params), pc)
    lora = tlora.from_jax_lora(_np(ad))
    want = jax_export(_np(params), CFG, lora=ad)
    got = export_torch_state_dict(model, pc, lora=lora)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6,
                                   rtol=0, err_msg=k)
    direct = export_torch_state_dict(tlora.merge_lora(model, lora), pc)
    _same_bits(got, direct)


@pytest.mark.parametrize("base_kind", ["step_dir", "safetensors"])
def test_export_tool_lora_base(tmp_path, base_kind):
    """``tools/export_hf --lora-base``: an adapter checkpoint merged into a
    step dir's or an HF safetensors dir's base weights is the file a direct
    export with ``lora=`` writes."""
    from v2pe_tpu_torch.tools import export_hf

    params, ad = _jax_adapters(CFG)
    pc = port_config(CFG)
    model = from_jax_params(_np(params), pc)
    lora = tlora.from_jax_lora(_np(ad))
    ckpt.save_checkpoint(str(tmp_path / "run"), 5, lora, {}, cfg=pc)
    if base_kind == "step_dir":
        base = ckpt.save_checkpoint(str(tmp_path / "base"), 1, model, {},
                                    cfg=pc)
    else:
        base = str(tmp_path / "hf")
        os.makedirs(base)
        save_safetensors(export_torch_state_dict(model, pc),
                         os.path.join(base, "model.safetensors"), "float32")
    out = export_hf.main(["--checkpoint", str(tmp_path / "run"), "--out",
                          str(tmp_path / "out"), "--lora-base", base,
                          "--dtype", "float32", "--platform", "cpu"])
    save_safetensors(export_torch_state_dict(model, pc, lora=lora),
                     str(tmp_path / "direct.safetensors"), "float32")
    assert open(out, "rb").read() == \
        open(tmp_path / "direct.safetensors", "rb").read()


def test_lora_view_leaves_the_base_and_recomputes_under_remat():
    """The training view aliases the base's storage without gradients,
    merges on access (so remat's recomputation sees the same weight), and
    its gradients reach the adapters only."""
    params, ad = _jax_adapters(CFG)
    pc = port_config(CFG)
    model = from_jax_params(_np(params), pc)
    lora = tlora.from_jax_lora(_np(ad))
    view = tlora.lora_view(model, lora)
    assert all(not p.requires_grad for p in view.parameters())
    for name, a in lora.targets().items():
        w = dict(view.named_modules())[name].weight
        torch.testing.assert_close(w, a.merged(
            dict(model.named_modules())[name].weight), rtol=0, atol=0)
    assert view.llm.layers[0].w1.parametrizations.weight.original \
        .data_ptr() == model.llm.layers[0].w1.weight.data_ptr()
    assert not hasattr(model.llm.layers[0].w1, "parametrizations")
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, 300, (1, 20)).astype(np.int32))
    grads = []
    for remat in (False, "full"):
        for p in lora.parameters():
            p.grad = None
        out, _ = tlm.llm_forward(view.llm, pc.llm, input_ids=ids, remat=remat)
        out.square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in
                      lora.named_parameters() if n.startswith("llm.")})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-9)
    assert all(p.grad is None for p in model.parameters())
