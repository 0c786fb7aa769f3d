"""Checkpoint loading and export of the port (``models/params.py``'s HF
converters, ``models/safetensors_io.py``, ``models/export.py``,
``tools/export_hf.py``, the train CLI's ``--model_name_or_path``) against
the JAX package's: HF-layout state dicts converted exactly, exports equal
key for key and array for array, loaded models' logits within the fp32
tolerance of the JAX forward, safetensors files interchangeable with the
``safetensors`` package's."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig, debug_tiny
from v2pe_tpu.models import internvl_chat as jchat
from v2pe_tpu.models.export import export_torch_state_dict as jax_export
from v2pe_tpu.models.export import save_safetensors as jax_save
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.models.params import \
    load_safetensors_checkpoint as jax_load_safetensors
from v2pe_tpu_torch.core import checkpoint as ckpt
from v2pe_tpu_torch.models import internvl_chat as tchat
from v2pe_tpu_torch.models import safetensors_io
from v2pe_tpu_torch.models.export import (export_torch_state_dict,
                                          save_safetensors)
from v2pe_tpu_torch.models.params import (convert_phi3_llm,
                                          convert_qwen2_llm,
                                          convert_torch_state_dict,
                                          from_jax_params,
                                          load_safetensors_checkpoint)

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import toy_dataset  # noqa: F401  (a fixture)
from .torch_parity import port_config, run_parity

ARCHS = ["internlm2", "qwen2", "llama", "phi3"]
TOL = dict(atol=2e-5, rtol=2e-5)  # fp32 end to end, as the model tests
IMG = 291  # <IMG_CONTEXT> id in the small vocab below


def _arch(cfg, arch):
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, arch=arch, qkv_bias=arch == "qwen2"))


def _tiny(arch="internlm2"):
    return _arch(debug_tiny(vocab_size=256), arch)


def _small(arch, heads=4, kv_heads=2):
    """A 56-pixel ViT and a 2-layer decoder, for forwards."""
    return _arch(VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=300, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=2, num_attention_heads=heads,
                      num_key_value_heads=kv_heads),
        rope_pos_id_stride=2), arch)


def _tree(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jax_init(jax.random.PRNGKey(seed), cfg, jnp.float32))


def _write(tmp_path, cfg, seed=0, dtype="float32"):
    """The JAX export of a random model as a checkpoint directory."""
    tree = _tree(cfg, seed)
    jax_save(jax_export(tree, cfg), str(tmp_path / "model.safetensors"),
             dtype=dtype)
    (tmp_path / "config.json").write_text(cfg.to_json())
    return tree


# --------------------------------------------------------------- converters


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_equals_from_jax_params_exactly(arch):
    cfg = _tiny(arch)
    tree = _tree(cfg)
    got = convert_torch_state_dict(jax_export(tree, cfg), port_config(cfg))
    want = from_jax_params(tree, port_config(cfg)).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_export_equals_jax_export_exactly(arch):
    cfg = _tiny(arch)
    tree = _tree(cfg)
    want = jax_export(tree, cfg)
    got = export_torch_state_dict(from_jax_params(tree, port_config(cfg)),
                                  port_config(cfg))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("arch,convert", [("qwen2", convert_qwen2_llm),
                                          ("llama", convert_qwen2_llm),
                                          ("phi3", convert_phi3_llm)])
def test_bare_causal_lm_converters(arch, convert):
    """A bare *ForCausalLM state dict (no ``language_model.`` prefix), with
    the head tied to the embedding when ``lm_head`` is absent."""
    cfg = _tiny(arch)
    tree = _tree(cfg)
    sd = {k[len("language_model."):]: v for k, v in
          jax_export(tree, cfg).items() if k.startswith("language_model.")}
    lc = port_config(cfg).llm
    want = from_jax_params(tree, port_config(cfg)).llm.state_dict()
    got = convert(sd, lc)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    del sd["lm_head.weight"]
    tied = convert(sd, lc)
    torch.testing.assert_close(tied["output.weight"],
                               want["tok_embeddings.weight"], rtol=0, atol=0)
    assert tied["output.weight"].data_ptr() != \
        tied["tok_embeddings.weight"].data_ptr()
    with pytest.raises(ValueError):
        (convert_phi3_llm if convert is convert_qwen2_llm
         else convert_qwen2_llm)(sd, lc)


def test_converter_refuses_a_state_dict_of_another_model():
    cfg = _tiny()
    sd = jax_export(_tree(cfg), cfg)
    del sd["mlp1.0.bias"]
    with pytest.raises(KeyError):
        convert_torch_state_dict(sd, port_config(cfg))
    with pytest.raises(ValueError, match="qwen2"):
        convert_torch_state_dict(sd, port_config(dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, arch="qwen2"))))


# ----------------------------------------------------------- loaded models


@pytest.mark.parametrize("arch,heads", [("qwen2", (4, 2)), ("llama", (4, 2)),
                                        ("phi3", (4, 2)), ("qwen2", (8, 2)),
                                        ("internlm2", (8, 2))])
def test_loaded_model_logits_match_jax(arch, heads, tmp_path):
    """The counterparts of ``tests/test_qwen2.py``'s parity: a checkpoint
    written by the JAX export, loaded by the port, against the JAX forward
    of the tree; (8, 2) heads is a G = 4 model (InternVL2.5-8B's 32 / 8)."""
    cfg = _small(arch, *heads)
    tree = _write(tmp_path, cfg, seed=3)
    model = load_safetensors_checkpoint(str(tmp_path), port_config(cfg),
                                        device="cpu")
    assert next(model.parameters()).dtype == torch.float32
    nit = cfg.num_image_token
    ids = np.concatenate([np.arange(10, 20), [290], [IMG] * nit, [292],
                          np.arange(30, 45)]).astype(np.int32)[None]
    S = ids.shape[1]
    rope = np.arange(S, dtype=np.float32)[None]
    rope[0, 11:11 + nit] = 10 + 0.5 * np.arange(1, nit + 1)
    rope[0, 11 + nit:] = rope[0, 10 + nit] + np.arange(1, S - 10 - nit)
    pixels = np.random.default_rng(0).standard_normal(
        (1, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        p = run_parity(
            lambda i, px, r: jchat.forward(
                tree, cfg, input_ids=i, pixel_values=px,
                image_flags=jnp.ones(1, jnp.int32), rope_pos_ids=r,
                img_context_token_id=IMG, attn_impl="jnp").logits,
            lambda i, px, r: tchat.forward(
                model, port_config(cfg), input_ids=i.long(), pixel_values=px,
                image_flags=torch.ones(1, dtype=torch.int32), rope_pos_ids=r,
                img_context_token_id=IMG).logits,
            ids, pixels, rope)
    p.assert_close(**TOL)


def test_loader_keeps_the_checkpoint_dtype_unless_asked(tmp_path):
    cfg = _tiny()
    _write(tmp_path, cfg, dtype="bfloat16")
    pc = port_config(cfg)
    m = load_safetensors_checkpoint(str(tmp_path), pc, device="cpu")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    m32 = load_safetensors_checkpoint(str(tmp_path), pc, torch.float32,
                                      device="cpu")
    assert {p.dtype for p in m32.parameters()} == {torch.float32}
    for a, b in zip(m.parameters(), m32.parameters()):
        torch.testing.assert_close(a.float(), b, rtol=0, atol=0)


def test_loader_without_device_needs_a_cuda_device(tmp_path, monkeypatch):
    """``device`` defaults to the card: where there is none it raises,
    naming the CPU, and never loads onto the CPU by itself."""
    cfg = _tiny()
    _write(tmp_path, cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_safetensors_checkpoint(str(tmp_path), port_config(cfg))
    with pytest.raises(FileNotFoundError):
        load_safetensors_checkpoint(str(tmp_path / "none"), port_config(cfg),
                                    device="cpu")


# ------------------------------------------------------------- file format


def _random_tensors(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    out = {f"t{i}": (torch.randn(*shape, generator=g) * 3).to(dtype)
           for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (1,)])}
    out["codes"] = torch.randint(-128, 128, (5, 3), generator=g,
                                 dtype=torch.int8)
    out["scalar"] = torch.tensor(1.5).to(dtype)
    out["empty"] = torch.zeros((0, 4), dtype=dtype)
    return out


def _assert_same_bits(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k].reshape(-1).view(torch.uint8),
                           b[k].reshape(-1).view(torch.uint8)), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_files_interchange_with_the_safetensors_package(dtype, tmp_path):
    """Files written here load through ``safetensors.torch.load_file`` bit
    for bit, and the package's ``save_file`` files load here bit for bit,
    over two shards of one directory."""
    st = pytest.importorskip("safetensors.torch")
    ours, theirs = _random_tensors(dtype, 0), _random_tensors(dtype, 1)
    theirs = {"x" + k: v for k, v in theirs.items()}
    (tmp_path / "a").mkdir()
    safetensors_io.save_file(ours, str(tmp_path / "a" / "1.safetensors"),
                             metadata={"format": "pt"})
    st.save_file(theirs, str(tmp_path / "a" / "2.safetensors"),
                 metadata={"format": "pt"})
    _assert_same_bits(st.load_file(str(tmp_path / "a" / "1.safetensors")),
                      ours)
    _assert_same_bits(safetensors_io.load_file(
        str(tmp_path / "a" / "2.safetensors")), theirs)
    _assert_same_bits(safetensors_io.load_dir(str(tmp_path / "a")),
                      {**ours, **theirs})
    _, meta, _ = safetensors_io.read_header(
        str(tmp_path / "a" / "1.safetensors"))
    assert meta == {"format": "pt"}


def test_reader_takes_unaligned_tensors_and_a_later_shard_wins(tmp_path):
    """Offsets that are no multiple of the element size (an odd int8
    tensor first), and a name in two shards: the later file's."""
    t = {"a": torch.arange(3, dtype=torch.int8),
         "b": torch.randn(4, dtype=torch.float32)}
    safetensors_io.save_file(t, str(tmp_path / "0.safetensors"))
    safetensors_io.save_file({"b": torch.ones(2)},
                             str(tmp_path / "1.safetensors"))
    one = safetensors_io.load_file(str(tmp_path / "0.safetensors"))
    _assert_same_bits(one, t)
    assert torch.equal(safetensors_io.load_dir(str(tmp_path))["b"],
                       torch.ones(2))
    with pytest.raises(FileNotFoundError):
        safetensors_io.load_dir(str(tmp_path / "nothing"))


def test_bf16_export_roundtrips_and_reads_as_the_jax_loader_reads_it(
        tmp_path):
    """The JAX package's default export is bf16: the port loads that file
    exactly, to the bits the JAX loader reads from it
    (``safe_open(framework="np")``, which knows bfloat16 once ``jax`` has
    imported ``ml_dtypes``), and its own bf16 export of the loaded model is
    the same file's tensors again."""
    cfg = _tiny()
    tree = _tree(cfg)
    jax_save(jax_export(tree, cfg), str(tmp_path / "model.safetensors"),
             dtype="bfloat16")
    jtree = jax_load_safetensors(str(tmp_path), cfg, jnp.bfloat16)
    pc = port_config(cfg)
    model = load_safetensors_checkpoint(str(tmp_path), pc, device="cpu")
    want = from_jax_params(jax.tree.map(np.asarray, jtree), pc,
                           dtype=torch.bfloat16)
    _assert_same_bits(model.state_dict(), want.state_dict())
    save_safetensors(export_torch_state_dict(model, pc),
                     str(tmp_path / "again.safetensors"))
    _assert_same_bits(
        safetensors_io.load_file(str(tmp_path / "again.safetensors")),
        safetensors_io.load_file(str(tmp_path / "model.safetensors")))


def test_quantized_decoder_dequantizes_on_export():
    """As ``tests/test_export.py``'s quantized case: the int8 weights come
    out as codes times scales in fp32, equal to the JAX export of the JAX
    quantized tree; an int4 decoder is refused, as the JAX export cannot
    take one either."""
    from v2pe_tpu.ops.quantized_matmul import quantize_llm_params as jquant

    from v2pe_tpu_torch.infer.chat import ChatModel

    cfg = _tiny()
    tree = _tree(cfg, seed=2)
    qtree = dict(tree, llm=jquant(jax.tree.map(jnp.asarray, tree["llm"]),
                                  bits=8))
    pc = port_config(cfg)
    model = from_jax_params(jax.tree.map(np.asarray, qtree), pc)
    want = jax_export(qtree, cfg)
    got = export_torch_state_dict(model, pc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    w = model.llm.stacks["w1"]
    np.testing.assert_array_equal(
        got["language_model.model.layers.0.feed_forward.w1.weight"].numpy(),
        (w.q[0].float() * w.scale[0])[:, :w.n_out].t().numpy())
    int4 = ChatModel(from_jax_params(tree, pc), pc, _toy_tokenizer(),
                     weights_dtype="int4").model
    with pytest.raises(NotImplementedError, match="int4"):
        export_torch_state_dict(int4, pc)
    with pytest.raises(NotImplementedError, match="LoRA"):
        export_torch_state_dict(model, pc, lora={})


# ------------------------------------------------------------ the tools


def test_export_tool_equals_a_direct_export(tmp_path, capsys):
    """``python -m v2pe_tpu_torch.tools.export_hf`` on a run directory that
    ``core/checkpoint.py`` wrote: its latest step, exported, is the file a
    direct export writes; ``--hf-template`` copies the non-weight files."""
    from v2pe_tpu_torch.tools import export_hf

    cfg = _tiny("qwen2")
    pc = port_config(cfg)
    model = from_jax_params(_tree(cfg, seed=4), pc)
    ckpt.save_checkpoint(str(tmp_path / "run"), 3, model, {}, cfg=pc)
    tmpl = tmp_path / "tmpl"
    tmpl.mkdir()
    (tmpl / "tokenizer_config.json").write_text("{}")
    (tmpl / "model.safetensors").write_text("old weights")
    out = export_hf.main(["--checkpoint", str(tmp_path / "run"), "--out",
                          str(tmp_path / "out"), "--hf-template", str(tmpl),
                          "--platform", "cpu"])
    assert "wrote" in capsys.readouterr().out
    save_safetensors(export_torch_state_dict(model, pc),
                     str(tmp_path / "direct.safetensors"))
    assert open(out, "rb").read() == \
        open(tmp_path / "direct.safetensors", "rb").read()
    assert (tmp_path / "out" / "tokenizer_config.json").read_text() == "{}"
    f32 = export_hf.main(["--checkpoint", str(tmp_path / "run" /
                                              "step_00000003"),
                          "--out", str(tmp_path / "out32"), "--dtype",
                          "float32", "--platform", "cpu"])
    back = load_safetensors_checkpoint(str(tmp_path / "out32"), pc,
                                       device="cpu")
    _assert_same_bits(back.state_dict(), model.state_dict())
    assert f32.endswith("model.safetensors")
    with pytest.raises(NotImplementedError, match="LoRA"):
        export_hf.main(["--checkpoint", str(tmp_path / "run"), "--out",
                        str(tmp_path / "x"), "--lora-base", "b",
                        "--platform", "cpu"])


def test_export_tool_without_platform_needs_a_cuda_device(tmp_path,
                                                          monkeypatch):
    from v2pe_tpu_torch.tools import export_hf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        export_hf.main(["--checkpoint", str(tmp_path), "--out",
                        str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def _first_loss(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return json.loads(f.readline())["loss"]


@pytest.mark.parametrize("arch", ["internlm2", "qwen2"])
def test_train_cli_starts_from_the_checkpoint(arch, tmp_path, monkeypatch,
                                              toy_dataset):  # noqa: F811
    """``--model_name_or_path`` (and ``--llm_arch``): the first step's loss
    equals that of the same run started from ``from_jax_params`` of the
    tree the checkpoint was exported from."""
    from v2pe_tpu_torch.models import params as tparams
    from v2pe_tpu_torch.train import cli

    cfg = _arch(debug_tiny(), arch)
    (tmp_path / "hf").mkdir()
    tree = _write(tmp_path / "hf", cfg, seed=5)
    tok_dir = str(tmp_path / "tok")
    _toy_tokenizer().save_pretrained(tok_dir)
    argv = ["--model_preset", "debug_tiny", "--llm_arch", arch,
            "--tokenizer", tok_dir, "--meta_path", toy_dataset,
            "--max_steps", "1", "--save_steps", "10", "--log_steps", "1",
            "--max_packed_tokens", "1024", "--max_tiles", "4",
            "--max_dynamic_patch", "1", "--warmup_steps", "1",
            "--learning_rate", "1e-3", "--dtype", "float32",
            "--platform", "cpu", "--sync_save", "--no_resume"]
    cli.main(argv + ["--output_dir", str(tmp_path / "a"),
                     "--model_name_or_path", str(tmp_path / "hf")])
    tcfg = port_config(cfg)
    monkeypatch.setattr(
        tparams, "init_vlm_params",
        lambda c, g, device, dtype: from_jax_params(tree, tcfg, device,
                                                    dtype))
    cli.main(argv + ["--output_dir", str(tmp_path / "b")])
    a, b = _first_loss(tmp_path / "a"), _first_loss(tmp_path / "b")
    assert np.isfinite(a) and a == b
    with pytest.raises(FileNotFoundError):
        cli.main(argv + ["--output_dir", str(tmp_path / "c"),
                         "--model_name_or_path", str(tmp_path / "none")])
