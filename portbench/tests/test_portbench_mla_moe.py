"""The pieces of the benchmark for a DeepSeek-V3 decoder (``kimi-vl-a3b``,
cell ``serve.kimi.longdoc``): the weights' layout against the port's
parameters, the sizes at published widths, the work counts by hand, the
output check's faults at a tiny size and, on the card, at the cell's own
size, and kernel #12 against its twin on the card."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench.lib import program, spec, weights, weights_mla_moe, \
    work_mla_moe
from portbench.run import judge
from tiny import HERE, tiny_mix

SEED = 2 ** 31 + 11
CELL = "serve.kimi.longdoc"


def _config():
    with open(os.path.join(HERE, "configs", "kimi-vl-a3b.json")) as f:
        return json.load(f)


def tiny_mla_cell() -> dict:
    """The configuration file's shape with every width and depth cut: 2
    decoder layers (dense, then 8 experts, top 2, 1 shared), latent 32,
    rotary 16; the decoder and the experts as wide as the weights' scale
    (N(0, 0.02)) needs for the experts to weigh in the residual as they
    do at the published widths."""
    conf = copy.deepcopy(_config())
    m = conf["model"]
    m["vision"].update(hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=2)
    m["llm"].update(hidden_size=512, intermediate_size=512,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16,
                    n_routed_experts=8, num_experts_per_tok=2,
                    moe_intermediate_size=512, n_shared_experts=1)
    return {"name": "tiny.longdoc", "chips": 1, "entry": {}, "config": conf,
            "traffic": tiny_mix("longdoc"), "limits": {}}


@pytest.mark.parametrize("tiny", [False, True])
def test_layout_is_the_ports_parameters(tiny):
    from v2pe_tpu_torch.models.internvl_chat import InternVLChatModel

    model = tiny_mla_cell()["config"]["model"] if tiny else \
        _config()["model"]
    with torch.device("meta"):
        port = InternVLChatModel(program.vlm_config(model))
    want = {n: tuple(p.shape) for n, p in port.named_parameters()}
    got = {n: s for n, s, _ in weights_mla_moe.layout(model)}
    assert got == want


@pytest.mark.parametrize("layers", [27, 8])
def test_published_sizes(layers):
    """The cell runs the published depth (27 layers, nothing reduced):
    about 15.96 B decoder parameters, 2.58 B active a token with the head,
    and 31,104 bytes of latents a token; at 8 layers the counts follow the
    depth."""
    conf = _config()
    assert conf["model"]["llm"]["num_hidden_layers"] == 27
    assert conf["num_hidden_layers"] == 27 and conf["reduced"] == []
    model = copy.deepcopy(conf["model"])
    model["llm"]["num_hidden_layers"] = layers
    s = work_mla_moe.Sizes(model)
    leaves = weights_mla_moe.layout(model)
    dec = sum(weights.numel(sh) for n, sh, _ in leaves if n.startswith("llm."))
    assert dec == s.decoder_params
    want = {27: (15.96, 2.58, 31104), 8: (4.85, 1.0, 9216)}[layers]
    assert round(dec / 1e9, 2) == want[0]
    assert round((s.token_params + s.head_params) / 1e9, 2) == \
        pytest.approx(want[1])
    assert s.latent_bytes == want[2]


def test_work_counts_by_hand():
    """The work of one admission and one generated token at the tiny
    shape, counted from its sizes."""
    cell = tiny_mla_cell()
    m = cell["config"]["model"]
    s = work_mla_moe.Sizes(m)
    D, H, L, V = 512, 4, 2, m["llm"]["vocab_size"]
    attn = D * H * 32 + D * 48 + 32 * H * 32 + H * 16 * D
    moe_layer = 8 * D + 3 * D * (2 * 512 + 512)
    per_token = L * attn + 3 * D * 512 + moe_layer
    assert s.token_params == per_token
    w = weights_mla_moe.make(m, 1, "cpu")
    assert s.head_params == w["llm.output.weight"].numel() == V * D
    # an admission: 100 tokens, 36 of them cached, chunks of 32, no tiles
    flops, roof = s.prefill(100, 36, 32, 0)
    pairs = sum(range(37, 101))
    want = 2 * per_token * 64 + 2 * V * D + 2 * H * (48 + 32) * pairs * L
    assert flops == pytest.approx(want)
    chunks = [(32, 36), (32, 68)]
    want_roof = sum(max(
        (m_ * H * 80 * 2 + (c0 + m_) * 48 * 2) / 3.35e12,
        2 * H * 80 * (m_ * c0 + m_ * (m_ + 1) / 2) / 989e12) * L
        for m_, c0 in chunks)
    assert roof == pytest.approx(want_roof)
    flops, nbytes, attn_f = s.decode_token(500)
    assert nbytes == (500 * 48 + H * 80 + 48) * 2 * L
    assert attn_f == 2 * H * 80 * 500 * L
    assert flops == pytest.approx(2 * (per_token + V * D) + attn_f)
    # the expert products: 10 pairs over 3 experts
    assert s.expert_roof_s(10, 3) == pytest.approx(max(
        (3 * 3 * D * 512 + 10 * 2 * D) * 2 / 3.35e12,
        6 * D * 512 * 10 / 989e12))


# ------------------------------------------------------------- faults
#
# Each fault is judged by the cell's own limits; the reference takes the
# program's expert choices at the compared positions (drivers/
# serve_mla_moe.py), so a choice flipped by rounding is not a fault.


def _limits():
    with open(os.path.join(HERE, "limits", f"{CELL}.json")) as f:
        return json.load(f)


def _judged(**kw):
    drv = spec.load_module("drivers", "serve_mla_moe")
    run = drv.run(tiny_mla_cell(), SEED, 3.0, False, device="cpu",
                  log=lambda m: None, **kw)
    checks = dict(run["checks"], failed=float(run["failed"]))
    return judge(checks, _limits())[0], checks, run


@pytest.fixture(scope="module")
def sound():
    ok, checks, run = _judged()
    return ok, checks, run


def test_sound_run_is_correct(sound):
    ok, checks, run = sound
    assert ok, checks
    assert checks["first_err"] < 0.05, checks
    assert checks["unrouted"] == 0 and checks["served_checked"] > 0, checks
    assert run["stats"]["moe_assignments"] > 0 and run["stats"]["moe_ns"]


def _latent_never_stored(monkeypatch):
    """No prompt latent reaches the pool: every chunk and decode step
    attends a pool the prefill left as it was."""
    from v2pe_tpu_torch.ops import mla_attention

    monkeypatch.setattr(mla_attention, "store_latents",
                        lambda *a, **kw: None)


def _routed_expert_dropped(monkeypatch):
    """One of each token's routed experts (the first the router lists)
    never reaches it."""
    from v2pe_tpu_torch.ops import moe

    experts = moe.experts

    def dropped(x, idx, weights, *a, **kw):
        return experts(x, idx, torch.cat([0 * weights[:, :1], weights[:, 1:]],
                                         1), *a, **kw)

    monkeypatch.setattr(moe, "experts", dropped)


FAULTS = {"latent_never_stored": _latent_never_stored,
          "routed_expert_dropped": _routed_expert_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    ok, checks, _ = _judged()
    assert not ok, checks


def test_positions_altered(monkeypatch):
    """Plain integer positions where V2PE's are due: not correct."""
    from v2pe_tpu_torch.infer import chat

    monkeypatch.setattr(chat, "build_v2pe_pos_ids",
                        lambda ids, mask, *a, **kw: np.arange(
                            len(ids), dtype=np.float32))
    ok, checks, _ = _judged()
    assert not ok, checks


def test_control_reads_far_worse_than_the_program(sound):
    _, checks, _ = _judged(control=True)
    assert checks["control_first_err"] > 4 * sound[1]["first_err"], checks


def test_unrecorded_choices_are_not_correct(monkeypatch):
    """An engine that kept no expert choices leaves its requests
    unrouted: not correct."""
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.setattr(InferenceEngine, "_route_log", lambda self: None)
    ok, checks, _ = _judged()
    assert not ok and checks["unrouted"] > 0, checks


# ------------------------------------------------------------ the card


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct_on_the_card(card, monkeypatch, fault):
    """Each fault at the cell's own size (its configuration, all 27
    layers, and its limits), in a short run of two clients with one
    document each."""
    c = spec.resolve(spec.load_benchmark(), CELL)
    mix = c["traffic"]
    mix.update(clients=2, ramp_s=2, stagger=0.0, rounds=1,
               questions_per_document=1,
               check={"served_tokens": 32, "max_requests": 2})
    FAULTS[fault](monkeypatch)
    drv = spec.load_module("drivers", "serve_mla_moe")
    run = drv.run(c, SEED, 4.0, False, device=card, log=print)
    checks = dict(run["checks"], failed=float(run["failed"]))
    print(fault, checks)
    assert checks["served_checked"] > 0, checks
    assert not judge(checks, c["limits"])[0], checks
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("form", ["decode", "chunk"])
def test_mla_kernel_matches_twin(card, form):
    """#12 at the cell's widths (16 heads, slots of 576) against its plain
    twin on the same bf16 inputs: within 1e-2 of the largest output (the
    kernel rounds the softmax weights to bf16), equal bits on a repeat."""
    from v2pe_tpu_torch.ops import mla_attention as mla

    g = torch.Generator(card).manual_seed(5)
    ps, MP, L = 128, 48, 2
    lengths = torch.tensor([0, 1000, 5000, 130], dtype=torch.int32,
                           device=card)
    B = len(lengths)
    NP = 1 + B * MP
    pool = torch.randn((L, 1, NP, ps, mla.DK), generator=g, device=card
                       ).to(torch.bfloat16)
    table = (torch.randperm(NP - 1, generator=g, device=card)[:B * MP] + 1
             ).int().view(B, MP)
    table[3, 2] = -1
    scale = 192 ** -0.5
    if form == "decode":
        q = torch.randn((B, 16, mla.DK), generator=g, device=card).to(
            torch.bfloat16)
        fresh = torch.randn((B, mla.DK), generator=g, device=card).to(
            torch.bfloat16)
        a = mla.mla_decode(q, fresh, pool.clone(), table, lengths, 1, scale,
                           512)
        b = mla.mla_decode(q, fresh, pool.clone(), table, lengths, 1, scale,
                           512)
        want = mla.mla_decode_torch(q, fresh, pool.clone(), table, lengths,
                                    1, scale, 512)
    else:
        q = torch.randn((B, 300, 16, mla.DK), generator=g, device=card).to(
            torch.bfloat16)
        a = mla.mla_chunk(q, pool, table, lengths, 1, scale, 512)
        b = mla.mla_chunk(q, pool, table, lengths, 1, scale, 512)
        want = mla.mla_chunk_torch(q, pool, table, lengths, 1, scale, 512)
    assert torch.equal(a, b)
    err = (a.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= 1e-2, float(err)
