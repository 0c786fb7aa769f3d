"""The operation and byte counts of ``lib/work.py`` against counts by hand
at a small configuration."""

import numpy as np
import pytest
import torch

from portbench.lib import weights, work
from tiny import tiny_config


def _sizes():
    return work.Sizes(tiny_config()["model"])


def test_causal_pairs_by_brute_force():
    for start, end in ((0, 1), (0, 7), (3, 9), (5, 5), (100, 257)):
        q = np.arange(start, end)[:, None]
        k = np.arange(end)[None]
        assert work.causal_pairs(start, end) == int((k <= q).sum())


def test_layer_and_head_parameters_match_the_weights():
    conf = tiny_config()
    s = work.Sizes(conf["model"])
    w = weights.make(conf["model"], 1, "cpu")
    layer = sum(w[f"llm.layers.0.{n}.weight"].numel()
                for n in ("wqkv", "wo", "w1", "w3", "w2"))
    assert s.layer_params == layer
    assert s.head_params == w["llm.output.weight"].numel()


def test_tile_flops_by_hand():
    s = _sizes()
    n, D, I, L = s.tile_tokens, s.vD, s.vI, s.vL
    vit = 2 * (n - 1) * 3 * 14 * 14 * D
    vit += L * 2 * n * (3 * D * D + D * D + D * I + I * D)
    vit += L * 2 * 2 * s.vhd * s.vH * n * n
    mlp1 = 2 * s.image_tokens * (4 * D * s.D + s.D * s.D)
    assert s.tile_flops() == pytest.approx(vit + mlp1)


def test_prefill_flops_and_roofline_by_hand():
    s = _sizes()
    S, cached, chunk, tiles = 300, 64, 128, 2
    flops, roof = s.prefill(S, cached, chunk, tiles)
    pairs = sum(i + 1 for i in range(cached, S))
    want = 2 * s.layer_params * s.L * (S - cached) + 2 * s.head_params \
        + 4 * s.hd * s.Hq * pairs * s.L + tiles * s.tile_flops()
    assert flops == pytest.approx(want)
    # the rooflines: ViT calls, then per chunk the self part (#1) and the
    # part over the cached pages (#6), each the larger of bytes and
    # operations at the peaks
    r = s.vit_attn_roof_s(tiles)
    qh, kh = s.Hq * s.hd * 2, s.Hkv * s.hd * 2
    for c0 in (64, 192):
        m = min(chunk, S - c0)
        # bytes of the valid rows only: the last chunk holds 108 of 128
        io1 = m * (2 * qh + 2 * kh) + m * s.Hq * 4
        f1 = 4 * s.hd * s.Hq * m * (m + 1) / 2
        io6 = m * (2 * qh + s.Hq * 4) + c0 * 2 * kh
        f6 = 4 * s.hd * s.Hq * m * c0
        r += s.L * (max(io1 / work.PEAK_BYTES_S, f1 / work.PEAK_FLOPS)
                    + max(io6 / work.PEAK_BYTES_S, f6 / work.PEAK_FLOPS))
    assert roof == pytest.approx(r)


def test_decode_token_by_hand():
    s = _sizes()
    ctx = 1000
    flops, nbytes, attn = s.decode_token(ctx)
    assert attn == 4 * s.hd * s.Hq * ctx * s.L
    assert flops == 2 * (s.layer_params * s.L + s.head_params) + attn
    kv = s.Hkv * s.hd * 2
    q = s.Hq * s.hd * 2
    assert nbytes == s.L * (ctx * 2 * kv + q + 2 * kv + q + s.Hq * 4
                            + 2 * kv)


def test_weights_follow_the_seed():
    m = tiny_config()["model"]
    a, b = weights.make(m, 3, "cpu"), weights.make(m, 3, "cpu")
    c = weights.make(m, 4, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["llm.output.weight"], c["llm.output.weight"])
    assert a["llm.output.weight"].dtype == torch.bfloat16
    assert torch.all(a["vision.layers.0.ls1"] == torch.tensor(
        0.1, dtype=torch.bfloat16))
    assert abs(float(a["llm.output.weight"].float().std()) - 0.02) < 0.002
