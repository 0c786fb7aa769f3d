"""The port's ``utils/`` (diagnostics and profiling) and the 2-D image
rotary (``ops/rope.rope_2d_cos_sin``) against the JAX package's on the
CPU."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.ops.rope import rope_2d_cos_sin as jax_rope_2d
from v2pe_tpu.utils import diagnostics as jdiag
from v2pe_tpu_torch.ops.rope import rope_2d_cos_sin
from v2pe_tpu_torch.utils import diagnostics, profiling


@pytest.mark.parametrize("h,w,d,base", [(3, 5, 16, 100.0), (7, 7, 64, 100.0),
                                        (2, 9, 32, 10000.0)])
def test_rope_2d_matches_jax(h, w, d, base):
    cos, sin = rope_2d_cos_sin(h, w, d, base)
    jc, js = jax_rope_2d(h, w, d, base)
    assert cos.shape == (h, w, d) and cos.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    # x varies down the rows on even channels, y across columns on odd ones
    np.testing.assert_array_equal(cos[0, :, 0::2].numpy(), 1.0)
    np.testing.assert_array_equal(cos[:, 0, 1::2].numpy(), 1.0)


def test_nan_guard_logs_only_non_finite(caplog):
    x = torch.arange(6.0)
    with caplog.at_level(logging.ERROR):
        assert diagnostics.nan_guard(x, "fine") is x
    assert not caplog.records
    bad = x.clone()
    bad[3] = float("inf")
    with caplog.at_level(logging.ERROR):
        assert diagnostics.nan_guard(bad, "attn_out") is bad
    assert "NaN/Inf detected in attn_out" in caplog.text
    # the JAX guard reports the same tensors
    with caplog.at_level(logging.ERROR):
        jdiag.nan_guard(jnp.asarray(bad.numpy()), "jax_attn_out")
    assert "jax_attn_out" in caplog.text


def test_assert_finite_names_the_path():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    diagnostics.assert_finite(model, "model")
    with torch.no_grad():
        model[1].bias[0] = float("nan")
    with pytest.raises(FloatingPointError, match="model:1.bias"):
        diagnostics.assert_finite(model, "model")
    tree = {"a": [torch.ones(2), {"b": torch.tensor([1.0, float("inf")])}],
            "n": torch.arange(3)}
    with pytest.raises(FloatingPointError, match=r"grads:a/\[1\]/b"):
        diagnostics.assert_finite(tree, "grads")
    with pytest.raises(FloatingPointError, match=r"grads:a/\[1\]/b"):
        jdiag.assert_finite({"a": [np.ones(2), {"b": np.array(
            [1.0, np.inf])}]}, "grads")
    diagnostics.assert_finite({"x": torch.zeros(2), "k": (torch.ones(1),)})


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.profile_trace(str(tmp_path)):
        with profiling.step_marker("train_step_7"):
            (x @ x).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "train_step_7" in names and "aten::mm" in names
