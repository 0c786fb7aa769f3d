"""The plain reference against the port at tiny sizes on the CPU: the
forward alone, and a whole serving run through the engine."""

import numpy as np
import pytest
import torch

from portbench.drivers import serve
from portbench.lib import program, traffic, weights, work
from portbench.lib.tokenizer import CodePointTokenizer
from portbench.reference import internvl, rules
from tiny import tiny_cell, tiny_config

SEED = 2 ** 31 + 99


@pytest.mark.parametrize("name,kv_heads", [("internvl2-2b", 2),
                                           ("internvl2_5-8b", 1)])
def test_reference_matches_the_ports_forward(name, kv_heads):
    """float32 on both sides: the port's packed forward and the reference
    over one prompt with two images, every position's logits."""
    from v2pe_tpu_torch.models import internvl_chat

    conf = tiny_config(name, kv_heads)
    m = conf["model"]
    W = weights.make(m, SEED, "cpu", dtype=torch.float32)
    cfg = program.vlm_config(m)
    model = program.build_model(cfg, W)
    tok = CodePointTokenizer()
    ctx = tok.convert_tokens_to_ids("<IMG_CONTEXT>")
    tiles = [1, 3]
    text = rules.prompt_text(conf["template"],
                             "<image>\n<image>\nabc 你好" * 5, tiles, 256)
    ids = np.asarray(tok.encode(text))
    pos = rules.v2pe_positions(ids, ctx, m["rope_pos_id_stride"], 256)
    px = torch.randn(4, 3, 448, 448, generator=torch.Generator().manual_seed(0))
    S = len(ids)
    with torch.no_grad():
        out = internvl_chat.forward(
            model, cfg, input_ids=torch.as_tensor(ids)[None],
            pixel_values=px, image_flags=torch.ones(4, dtype=torch.int32),
            rope_pos_ids=torch.as_tensor(pos)[None],
            img_context_token_id=ctx,
            segment_ids=torch.ones((1, S), dtype=torch.int32),
            token_positions=torch.arange(S, dtype=torch.int32)[None])
        ref = internvl.Reference(m, W.__getitem__, "cpu")
        want = ref.logits_at(ref.embed(ids, ctx, ref.vision(px)), pos,
                             range(S))
    got = out.logits[0].float()
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-4, err


def test_positions_rule_matches_the_ports():
    from v2pe_tpu_torch.positional.v2pe import build_v2pe_pos_ids

    tok = CodePointTokenizer()
    conf = tiny_config()
    for tiles in ([1], [3, 1, 7], [13, 13, 13]):
        text = rules.prompt_text(conf["template"],
                                 "<image>\nx" * len(tiles) + "yz", tiles, 256)
        ids = np.asarray(tok.encode(text))
        for stride in (1, 16, 64, 256):
            want = build_v2pe_pos_ids(
                ids, np.ones_like(ids), tiles,
                img_start_id=tok.convert_tokens_to_ids("<img>"),
                img_end_id=tok.convert_tokens_to_ids("</img>"),
                num_image_token=256, version="v2pe_fix", stride=stride)
            got = rules.v2pe_positions(
                ids, tok.convert_tokens_to_ids("<IMG_CONTEXT>"), stride, 256)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("config,mix", [("internvl2-2b", "mmdoc"),
                                        ("internvl2_5-8b", "docqa")])
def test_serving_run_agrees_with_the_reference(config, mix):
    cell = tiny_cell(config, mix)
    run = serve.run(cell, SEED, 8.0, False, device="cpu", log=lambda m: None)
    c = run["checks"]
    # a loaded CPU may send little inside the window: the check reads the
    # requests that finished, those of the ramp included
    assert run["failed"] == 0 and run["checked_requests"] >= 1
    assert c["prompt_mismatch"] == 0 and c["pos_err"] == 0
    assert c["unchecked"] == 0 and c["served_checked"] > 0
    assert c["first_err"] < 0.02, c
    assert c["gap"] < 0.05, c
    if mix == "docqa":
        assert run["stats"]["prefix_hit_pages"] > 0


def test_sizes_of_the_configurations_are_the_published_ones():
    import json
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, layer_params, head in (("internvl2-2b", 62914560, 189548544),
                                     ("internvl2_5-8b", 218103808,
                                      379097088)):
        with open(os.path.join(here, "configs", f"{name}.json")) as f:
            s = work.Sizes(json.load(f)["model"])
        assert s.layer_params == layer_params
        assert s.head_params == head
    assert traffic.CJK[1] + 3 < CodePointTokenizer().LIMIT
