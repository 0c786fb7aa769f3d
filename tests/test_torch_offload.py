"""The offloaded optimizer (``offload_optimizer``: int8 Adam moments in host
memory, staged through the device one segment at a time) against the
resident int8 step and against JAX's offloaded step, on the CPU in fp32
with tiny models: ``make_train_step``, ``trainer.train`` with a resume, the
train CLI, the checkpoint's restore of pinned host state, and the
refusals JAX asserts.

Off the card the stager copies host to host through the same code, so the
staging is exercised here; its streams, events and pinned memory run on
the card (``chip_smoke.py --8b``).

Tolerances. Offloaded against resident: equal to the bit (the staged
update is ``adam8bit.update`` itself). Against JAX's offloaded step: those
of ``tests/test_torch_train.py``'s int8 train steps (loss 1e-5 relative,
grad norm 1e-4, parameters 1e-5) and of
``tests/test_torch_dist_int8.py``'s int8 train steps for the moments
(scales 1e-5 of the leaf's largest, codes within 1 step on at most 5 in
10^5 of them).
"""

import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.train import optimizer as jopt
from v2pe_tpu.train import train_step as jstep
from v2pe_tpu_torch.core import checkpoint as ckpt
from v2pe_tpu_torch.models.params import _jax_state_dict, from_jax_params
from v2pe_tpu_torch.train import adam8bit
from v2pe_tpu_torch.train import optimizer as topt
from v2pe_tpu_torch.train import train_step as tstep

from .test_data_pipeline import _toy_tokenizer
from .test_datasets_packing import tokenizer, toy_dataset  # noqa: F401
from .test_torch_dist_int8 import check_moments, jax_int8_state
from .test_torch_train import (IMG, LOSS_RTOL, _batch, _cfg, _np,
                               _toy_run, _torch_batch)
from .torch_parity import one_thread, port_config  # noqa: F401

TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
          use_8bit_optimizer=True)
STEPS = 3


def _port_steps(cfg, params, offload: bool, steps=STEPS):
    """The port's int8 train steps on ``_batch()``: losses, grad norms,
    the model, the state and the optimizer."""
    model = from_jax_params(_np(params), port_config(cfg))
    opt = topt.build_optimizer(topt.TrainConfig(
        **TC, offload_optimizer=offload), model, port_config(cfg))
    step = tstep.make_train_step(port_config(cfg), opt,
                                 img_context_token_id=IMG, remat=True,
                                 offload_optimizer=offload)
    state, batch = opt.init(), _torch_batch(_batch())
    losses, norms = [], []
    for _ in range(steps):
        loss, gnorm = step(model, state, batch)
        losses.append(float(loss))
        norms.append(float(gnorm))
    return losses, norms, model, state, opt


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg()
    params = jax_init(jax.random.PRNGKey(0), cfg)
    return cfg, params, _port_steps(cfg, params, False), \
        _port_steps(cfg, params, True)


def test_offloaded_steps_equal_resident_steps_to_the_bit(runs):
    """Three steps: losses, grad norms, parameters, codes and scales equal
    bit for bit; the state stayed on the host and went through the stager
    (each segment's bytes copied each way)."""
    _, _, (l0, n0, m0, s0, _), (l1, n1, m1, s1, opt) = runs
    assert l0 == l1 and n0 == n1
    for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), n
    assert s0.keys() == s1.keys() and s0["count"] == s1["count"] == STEPS
    held = 0
    for key, mom in s0["moments"].items():
        for part, t in mom.items():
            got = s1["moments"][key][part]
            assert got.device.type == "cpu" and torch.equal(t, got), \
                (key, part)
            held += got.numel() * got.element_size()
    assert opt.stager is not None and opt.stager.moved == held
    assert opt.stager.copy_ms() is None  # timed on the card only


def test_offloaded_steps_match_jax_offloaded_steps(runs):
    """The same three steps against JAX's ``offload_optimizer=True`` step
    (``tests/test_train_step.py:176``'s optimizer): losses, grad norms,
    parameters and the int8 state within the stated tolerances."""
    cfg, params, _, (losses, norms, model, state, _) = runs
    tc = jopt.TrainConfig(**TC, offload_optimizer=True)
    tx = jopt.build_optimizer(tc, params)
    fn = jstep.make_train_step(cfg, tx, None, IMG, attn_impl="jnp",
                               remat=True, donate=False,
                               offload_optimizer=True)
    jstate, jb = tx.init(params), {k: jnp.asarray(v)
                                   for k, v in _batch().items()}
    for i in range(STEPS):
        params, jstate, m = fn(params, jstate, jb)
        np.testing.assert_allclose(losses[i], float(m["loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(norms[i], float(m["grad_norm"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    want = _jax_state_dict(_np(params), port_config(cfg))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   rtol=0, err_msg=n)
    got = {k: {t: v.numpy() for t, v in mom.items()}
           for k, mom in state["moments"].items()}
    check_moments(got, jax_int8_state(jstate, got), scale_tol=1e-5,
                  code_frac=5e-5)


def test_offload_without_int8_raises_as_jax_asserts():
    cfg = _cfg(1)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    with pytest.raises(AssertionError, match="use_8bit_optimizer"):
        jopt.build_optimizer(jopt.TrainConfig(offload_optimizer=True),
                             params)
    model = from_jax_params(_np(params), port_config(cfg))
    with pytest.raises(ValueError, match="use_8bit_optimizer"):
        topt.build_optimizer(topt.TrainConfig(offload_optimizer=True),
                             model, port_config(cfg))
    # a step told to offload takes an optimizer built to
    opt = topt.build_optimizer(topt.TrainConfig(use_8bit_optimizer=True),
                               model, port_config(cfg))
    with pytest.raises(ValueError, match="offload_optimizer=True"):
        tstep.make_train_step(port_config(cfg), opt, offload_optimizer=True)


def test_offload_with_lora_raises_as_jax_asserts():
    from v2pe_tpu_torch.models.lora import build_lora

    cfg = _cfg(1)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tx = jopt.build_optimizer(jopt.TrainConfig(**TC), params)
    with pytest.raises(AssertionError, match="LoRA"):
        jstep.make_train_step(cfg, tx, None, IMG, lora=True,
                              offload_optimizer=True)
    model = from_jax_params(_np(params), port_config(cfg))
    lora = build_lora(torch.Generator().manual_seed(0), model, llm_r=2)
    opt = topt.build_optimizer(topt.TrainConfig(**TC, offload_optimizer=True),
                               lora, port_config(cfg))
    with pytest.raises(ValueError, match="LoRA"):
        tstep.make_train_step(port_config(cfg), opt, lora=True,
                              offload_optimizer=True)


def test_stager_is_the_update_at_a_segments_offset():
    """Segments of one leaf's state, staged through two buffers of the
    largest segment's size, update to the bits of the resident update of
    the whole leaf at their offsets; a ragged last block included."""
    rng = np.random.default_rng(0)
    sizes = [3 * adam8bit.BLOCK, 5 * adam8bit.BLOCK, 2 * adam8bit.BLOCK + 7]
    numel = sum(sizes)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8,
              bc1=topt._bias_correction(0.9, 2),
              bc2=topt._bias_correction(0.999, 2))
    resident, host = adam8bit.zeros(numel), adam8bit.zeros(numel)
    stager = adam8bit.Stager("cpu")
    for _ in range(2):
        g = torch.from_numpy(rng.standard_normal(numel).astype(np.float32))
        want = adam8bit.update(g, resident, 0, **kw)
        offsets = np.cumsum([0] + sizes)
        segs = [adam8bit.segment(host, int(o), n)
                for o, n in zip(offsets, sizes)]
        got = torch.empty_like(g)

        def fn(i, st):
            o = int(offsets[i])
            assert not any(st[k].data_ptr() == segs[i][k].data_ptr()
                           for k in st)  # a staged copy, not the host view
            got[o:o + sizes[i]] = adam8bit.update(g[o:o + sizes[i]], st, 0,
                                                  **kw)

        stager.run(segs, fn)
        assert torch.equal(got, want)
        for k in resident:
            assert torch.equal(host[k], resident[k]), k
    assert stager.moved == sum(t.numel() * t.element_size()
                               for t in host.values())
    with pytest.raises(ValueError, match="multiple"):
        adam8bit.segment(host, 100, 10)


def test_the_8b_stacked_leaf_offsets_stay_exact():
    """InternVL2.5-8B's stacked FFN leaf holds 32 x 4096 x 14336 =
    1,879,048,192 codes, near 2^31: its last layer's segment starts at
    1,820,327,936. Offsets are Python integers and tensor indices int64 on
    this path (the kernels' layer offset is ``size_t``,
    ``csrc/quantized_matmul.cu``), so the last layer's segment views and
    update land where they should (on the meta device: shapes only)."""
    layer, layers = 4096 * 14336, 32
    state = adam8bit.zeros(layer * layers, device="meta")
    off = layer * (layers - 1)
    seg = adam8bit.segment(state, off, layer)
    assert seg["m_code"].numel() == layer
    assert seg["m_code"].storage_offset() == off > 2 ** 30
    assert seg["m_scale"].storage_offset() == off // adam8bit.BLOCK
    assert seg["v_scale"].numel() == layer // adam8bit.BLOCK
    out = adam8bit.update(torch.empty(layer, device="meta"), seg, 0,
                          b1=0.9, b2=0.999, eps=1e-8,
                          bc1=torch.tensor(0.1), bc2=torch.tensor(0.001))
    assert out.shape == (layer,)


def test_restore_keeps_the_templates_pinning(monkeypatch):
    """``_like`` pins a restored tensor where the template's is pinned
    (pinning faked: this build has no CUDA to pin with), and leaves the
    others as they are."""
    pinned = set()
    monkeypatch.setattr(torch.Tensor, "is_pinned",
                        lambda self: self.data_ptr() in pinned)

    def pin(self):
        out = self.clone()
        pinned.add(out.data_ptr())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    host, other = torch.zeros(4, dtype=torch.int8), torch.zeros(2)
    pinned.add(host.data_ptr())
    got = ckpt._like({"m": {"m_code": torch.ones(4, dtype=torch.int32)},
                      "x": torch.ones(2, dtype=torch.float64)},
                     {"m": {"m_code": host}, "x": other})
    assert got["m"]["m_code"].is_pinned()
    assert got["m"]["m_code"].dtype == torch.int8
    assert not got["x"].is_pinned() and got["x"].dtype == torch.float32


def test_trainer_offload_resumes_equal_to_uninterrupted(
        toy_dataset, tokenizer, tmp_path, caplog):
    """``trainer.train(offload_optimizer=True)``: four steps, a resume
    from step 2 gives steps 3-4 the uninterrupted run's losses, parameters
    and int8 state, bit for bit, with the moments back on the host; and
    the offloaded run equals the resident one."""
    m1, s1, log1 = _toy_run(toy_dataset, tokenizer, tmp_path / "out", False,
                            offload_optimizer=True)
    assert ckpt.list_checkpoints(str(tmp_path / "out")) == [2, 4]
    shutil.rmtree(tmp_path / "out" / "step_00000004")
    with caplog.at_level(logging.INFO):
        m2, s2, log2 = _toy_run(toy_dataset, tokenizer, tmp_path / "out",
                                True, offload_optimizer=True)
    assert "resumed from" in caplog.text
    assert [s for s, _ in log2] == [3, 4]
    assert [m["loss"] for _, m in log2] == [m["loss"] for _, m in log1[2:]]
    for (n, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), n
    for key, mom in s1["moments"].items():
        for part, t in mom.items():
            assert s2["moments"][key][part].device.type == "cpu"
            assert torch.equal(t, s2["moments"][key][part]), (key, part)
    m0, s0, log0 = _toy_run(toy_dataset, tokenizer, tmp_path / "resident",
                            False)
    assert [m["loss"] for _, m in log0] == [m["loss"] for _, m in log1]
    for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(a, b), n


def test_cli_offload_trains_and_resumes(toy_dataset, tmp_path, caplog):
    """``--offload_optimizer`` trains a step through the CLI (int8 Adam
    turned on by it), then a second run resumes from it and takes step
    2."""
    from v2pe_tpu_torch.train import cli

    tok_dir = str(tmp_path / "tok")
    _toy_tokenizer().save_pretrained(tok_dir)
    argv = ["--model_preset", "debug_tiny", "--tokenizer", tok_dir,
            "--meta_path", toy_dataset, "--output_dir",
            str(tmp_path / "out"), "--save_steps", "1", "--log_steps", "1",
            "--max_packed_tokens", "512", "--max_tiles", "2",
            "--max_dynamic_patch", "1", "--warmup_steps", "1",
            "--learning_rate", "1e-3", "--dtype", "float32", "--platform",
            "cpu", "--sync_save", "--offload_optimizer"]
    _, state, step = cli.main(argv + ["--max_steps", "1"])
    assert step == 1 and state["count"] == 1
    assert ckpt.list_checkpoints(str(tmp_path / "out")) == [1]
    with caplog.at_level(logging.INFO):
        _, state, step = cli.main(argv + ["--max_steps", "2"])
    assert "resumed from" in caplog.text and step == 2
    assert state["count"] == 2
    assert ckpt.list_checkpoints(str(tmp_path / "out")) == [1, 2]
    assert all(t.device.type == "cpu" for mom in state["moments"].values()
               for t in mom.values())
