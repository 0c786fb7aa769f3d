"""The DeepSeek-V3 decoder (Kimi-VL-A3B's language model) behind InternViT:
the plain reference (``tests/ref_deepseek_v3.py``) against ``transformers``'
DeepSeek-V3 layers, the port against the reference through the latent
pages and the engine, the router and the experts, kernel #12's plain twin
against plain attention, the checkpoint mapping and the engine's refusals.

Sizes: 2 decoder layers (layer 0 dense, layer 1 of 8 experts, top 2, 1
shared), latent 32, rotary 16, behind a 2-layer ViT at 56 px (4 image
tokens a tile) and V2PE stride 2, so image positions step by 0.5.

Tolerances: float32 throughout, so the port and the reference differ only
in the order of their sums (the absorbed against the expanded attention,
grouped against per-expert products): 2e-5 of the largest logit, as
``test_torch_models.py`` holds the dense decoders."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench.lib.tokenizer import CodePointTokenizer
from v2pe_tpu_torch.core.config import MLAConfig, VisionConfig, VLMConfig
from v2pe_tpu_torch.infer import paged_kv as pk
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
from v2pe_tpu_torch.infer.generate import GenerationConfig
from v2pe_tpu_torch.models import decoder, internvl_chat, params
from v2pe_tpu_torch.ops import mla_attention as mla
from v2pe_tpu_torch.ops import moe
from v2pe_tpu_torch.serve.engine import InferenceEngine

from . import ref_deepseek_v3 as ref

TOL = 2e-5


def _cfg(**llm) -> VLMConfig:
    lc = dict(vocab_size=640, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
              qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8,
              n_shared_experts=1, num_experts_per_tok=2,
              moe_intermediate_size=32, first_k_dense_replace=1,
              routed_scaling_factor=2.446, rope_theta=800000.0)
    lc.update(llm)
    return VLMConfig(
        vision=VisionConfig(hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=56, patch_size=14),
        llm=MLAConfig(**lc), template="internlm2-chat", rope_pos_id_stride=2)


@torch.no_grad()
def _model(cfg: VLMConfig, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    model = internvl_chat.InternVLChatModel(cfg)
    for name, p in model.named_parameters():
        if name.endswith(("norm", "norm1", "norm2", "ln_weight", "kv_norm")):
            p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
        elif name.endswith(("ls1", "ls2")):
            p.fill_(0.1)
        else:
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


def _reference(cfg, model):
    sd = model.state_dict()
    return ref.Reference(dataclasses.asdict(cfg), sd.__getitem__, "cpu")


def _close(got, want):
    scale = want.abs().max()
    assert (got - want).abs().max() <= TOL * scale, \
        float((got - want).abs().max() / scale)


# ------------------------------------------- the reference and transformers


def _hf(cfg: VLMConfig, seed: int = 3):
    tr = pytest.importorskip("transformers")
    lc = cfg.llm
    hc = tr.DeepseekV3Config(
        vocab_size=lc.vocab_size, hidden_size=lc.hidden_size,
        intermediate_size=lc.intermediate_size,
        moe_intermediate_size=lc.moe_intermediate_size,
        num_hidden_layers=lc.num_hidden_layers,
        num_attention_heads=lc.num_attention_heads,
        num_key_value_heads=lc.num_key_value_heads,
        n_shared_experts=lc.n_shared_experts,
        n_routed_experts=lc.n_routed_experts,
        routed_scaling_factor=lc.routed_scaling_factor,
        kv_lora_rank=lc.kv_lora_rank, q_lora_rank=None,
        qk_rope_head_dim=lc.qk_rope_head_dim, v_head_dim=lc.v_head_dim,
        qk_nope_head_dim=lc.qk_nope_head_dim, n_group=1, topk_group=1,
        num_experts_per_tok=lc.num_experts_per_tok,
        first_k_dense_replace=lc.first_k_dense_replace, norm_topk_prob=True,
        rope_theta=lc.rope_theta, rms_norm_eps=lc.rms_norm_eps,
        max_position_embeddings=4096, rope_interleave=True,
        attention_bias=False, tie_word_embeddings=False)
    hc._attn_implementation = "eager"
    torch.manual_seed(seed)
    hf = tr.DeepseekV3ForCausalLM(hc).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
        for layer in hf.model.layers[lc.first_k_dense_replace:]:
            layer.mlp.gate.e_score_correction_bias.copy_(
                0.1 * torch.randn(lc.n_routed_experts, generator=g))
    return hf


@pytest.mark.parametrize("fractional", [False, True])
def test_reference_matches_transformers(fractional):
    """The reference (and the port's full forward) on an HF
    DeepseekV3ForCausalLM's weights, mapped by ``params``: the same
    logits, at integer and at fractional (V2PE) positions."""
    cfg = _cfg()
    hf = _hf(cfg)
    sd = params.convert_deepseek_v3_llm(hf.state_dict(), cfg.llm)
    S = 12
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(3, cfg.llm.vocab_size, (1, S)))
    pos = np.arange(S, dtype=np.float32)
    if fractional:
        pos[3:9] = 3 + 0.5 * np.arange(6, dtype=np.float32)
        pos[9:] = pos[8] + 1 + np.arange(S - 9)
    with torch.no_grad():
        want = hf(input_ids=ids, position_ids=torch.as_tensor(pos)[None]
                  ).logits[0]
        r = ref.Reference(dataclasses.asdict(cfg),
                          lambda n: sd[n[len("llm."):]], "cpu")
        x = sd["tok_embeddings.weight"][ids[0]].float()
        _close(r.logits_at(x, pos, range(S)), want)
        llm = decoder.build(cfg.llm)
        llm.load_state_dict(sd)
        got, _ = decoder.llm_forward(
            llm, cfg.llm, input_ids=ids,
            rope_pos_ids=torch.as_tensor(pos)[None])
    _close(got[0], want)


# -------------------------------------------- the port through the pages


def _prompt(cfg, chat, tiles, text, seed=5):
    ids, pos, _ = chat.encode_chat("<image>\n" * len(tiles) + text, tiles)
    g = torch.Generator().manual_seed(seed)
    px = torch.randn((sum(tiles), 3, 56, 56), generator=g)
    return np.asarray(ids), np.asarray(pos, np.float32), px


def _ref_logits(cfg, r, chat, ids, pos, px, rows):
    img = r.vision(px)
    x = r.embed(ids, chat.img_context_token_id, img)
    return r.logits_at(x, pos, rows)


def test_paged_prefill_then_decode_matches_reference():
    """Chunked prefill through the latent pool (three chunks, the last
    padded), then decode steps: each step's logits against the
    reference's full forward over the prompt and the tokens fed so far."""
    cfg = _cfg()
    model = _model(cfg)
    tok = CodePointTokenizer(cfg.llm.vocab_size)
    chat = ChatModel(model, cfg, tok)
    ids, pos, px = _prompt(cfg, chat, [2, 1], "abcdefghij" * 4)
    S, CH, steps = len(ids), 32, 3
    llm = model.llm
    cache = pk.PagedKVCache.latents(cfg.llm, 1, 32, 8, 24,
                                    dtype=torch.float32)
    with torch.no_grad():
        emb = llm.tok_embeddings(torch.as_tensor(ids)[None])
        vit = internvl_chat.extract_feature(model, cfg, px)
        emb = internvl_chat.scatter_image_embeds(
            emb, torch.as_tensor(ids)[None], vit,
            torch.ones(len(px), dtype=torch.int32),
            chat.img_context_token_id)
        Sp = -(-S // CH) * CH
        emb = torch.nn.functional.pad(emb, (0, 0, 0, Sp - S))
        pos_p = torch.as_tensor(np.pad(pos, (0, Sp - S)))[None]
        seg = (torch.arange(Sp) < S).to(torch.int32)[None]
        for c in range(0, Sp, CH):
            hidden, cache = chunked_prefill(
                llm, cfg.llm, cache, inputs_embeds=emb[:, c:c + CH],
                rope_pos_ids=pos_p[:, c:c + CH], segment_ids=seg[:, c:c + CH],
                return_hidden=True)
        got = [torch.nn.functional.linear(
            hidden[0, (S - 1) % CH].float(), llm.output.weight)]
        fed = list(ids)
        p_all = list(pos)
        for _ in range(steps):
            nxt = int(got[-1].argmax())
            fed.append(nxt)
            p_all.append(p_all[-1] + 1)
            cache = pk.allocate_rows(cache, torch.ones(1, dtype=torch.int32))
            logits, cache = decoder.llm_forward(
                llm, cfg.llm, input_ids=torch.tensor([[nxt]]),
                rope_pos_ids=torch.tensor([[p_all[-1]]]), paged_cache=cache)
            cache = pk.advance_lengths(cache, 1)
            got.append(logits[0, 0])
        r = _reference(cfg, model)
        want = _ref_logits(cfg, r, chat, np.asarray(fed),
                           np.asarray(p_all, np.float32), px,
                           range(S - 1, S + steps))
    for i, g in enumerate(got):
        _close(g, want[i])


def test_engine_with_prefix_hit_matches_reference():
    """A 2-row engine over the latent pool: two questions on one document
    (the second finds its pages in the prefix cache) and a third request
    beside them; each first token's logits against the reference, and
    every served token the reference's best."""
    cfg = _cfg()
    model = _model(cfg, seed=1)
    tok = CodePointTokenizer(cfg.llm.vocab_size)
    chat = ChatModel(model, cfg, tok)
    eng = InferenceEngine(
        chat, max_rows=2, max_len=256, page_size=8, chunk_size=32,
        decode_block=3, generation_config=GenerationConfig(
            do_sample=False, eos_token_ids=(-1,)))
    g = torch.Generator().manual_seed(7)
    px = torch.randn((3, 3, 56, 56), generator=g).numpy()
    doc = "<image>\n<image>\n" + "document text " * 4
    reqs = [eng.submit_chat(px, doc + "question one?", max_new_tokens=5,
                            num_patches_list=[2, 1]),
            eng.submit_chat(None, "plain text, no image", max_new_tokens=4)]
    eng.run_until_idle()
    reqs.append(eng.submit_chat(px, doc + "question two, longer?",
                                max_new_tokens=4, num_patches_list=[2, 1]))
    eng.run_until_idle()
    assert eng.stats["prefix_hit_pages"] > 0 and reqs[2].cached_tokens > 0
    assert eng.stats["moe_assignments"] > 0
    assert eng.stats["moe_experts_hit"] <= eng.stats["moe_assignments"]
    r = _reference(cfg, model)
    with torch.no_grad():
        for q in reqs:
            S, n = len(q.ids), len(q.tokens)
            full = np.concatenate([q.ids, q.tokens[:-1]])
            fpos = np.concatenate([q.pos, q.pos[-1] + np.arange(
                1, n, dtype=np.float32)])
            pix = None if q.pixel_values is None else \
                torch.as_tensor(q.pixel_values)
            img = r.vision(pix) if pix is not None else torch.zeros(0)
            want = r.logits_at(r.embed(full, chat.img_context_token_id, img),
                               fpos, range(S - 1, S - 1 + n))
            _close(q.first_logits, want[0])
            best = want.max(-1).values
            served = want.gather(1, torch.as_tensor(q.tokens)[:, None])[:, 0]
            assert torch.all(best - served <= TOL * best.abs().max())


def test_engine_records_each_served_tokens_experts():
    """With ``record_routes`` a request keeps, for each served token, the
    experts each MoE layer chose at the position that produced it: the
    first token's from its admission's last chunk (after a prefix hit
    too), the others' from the decode blocks' harvests; they are the
    experts a full forward over the same tokens chooses there. Without
    it, nothing is kept."""
    cfg = _cfg(num_hidden_layers=3)
    model = _model(cfg, seed=2)
    tok = CodePointTokenizer(cfg.llm.vocab_size)
    chat = ChatModel(model, cfg, tok)
    gc = GenerationConfig(do_sample=False, eos_token_ids=(-1,))
    eng = InferenceEngine(chat, max_rows=2, max_len=256, page_size=8,
                          chunk_size=32, decode_block=3,
                          generation_config=gc, record_routes=True)
    g = torch.Generator().manual_seed(9)
    px = torch.randn((3, 3, 56, 56), generator=g).numpy()
    doc = "<image>\n<image>\n" + "a document " * 5
    reqs = [eng.submit_chat(px, doc + "first?", max_new_tokens=5,
                            num_patches_list=[2, 1]),
            eng.submit_chat(None, "no image here", max_new_tokens=7)]
    eng.run_until_idle()
    reqs.append(eng.submit_chat(px, doc + "second, warm?", max_new_tokens=4,
                                num_patches_list=[2, 1]))
    eng.run_until_idle()
    assert reqs[2].cached_tokens > 0
    llm = model.llm
    for q in reqs:
        S, n = len(q.ids), len(q.tokens)
        assert np.asarray(q.routes).shape == (n, 2, 2)
        full = np.concatenate([q.ids, q.tokens[:-1]])
        fpos = np.concatenate([q.pos, q.pos[-1] + np.arange(
            1, n, dtype=np.float32)])
        ids_t = torch.as_tensor(full)[None]
        with torch.no_grad():
            emb = llm.tok_embeddings(ids_t)
            if q.pixel_values is not None:
                vit = internvl_chat.extract_feature(
                    model, cfg, torch.as_tensor(q.pixel_values))
                emb = internvl_chat.scatter_image_embeds(
                    emb, ids_t, vit, torch.ones(3, dtype=torch.int32),
                    chat.img_context_token_id)
            llm.route_log = []
            decoder.llm_forward(llm, cfg.llm, inputs_embeds=emb,
                                rope_pos_ids=torch.as_tensor(fpos)[None])
            log, llm.route_log = llm.route_log, None
        want = torch.stack(log, 1)[S - 1:S - 1 + n].sort(-1).values
        assert np.array_equal(np.sort(np.asarray(q.routes), -1),
                              want.numpy())
    eng.record_routes = False
    plain = eng.submit_chat(None, "no image here", max_new_tokens=4)
    eng.run_until_idle()
    assert plain.routes == [] and len(plain.tokens) == 4


# --------------------------------------------------------- the router


def _route(x, gate, bias, **kw):
    kw = dict(top_k=2, norm_topk_prob=True, scaling=2.446) | kw
    return moe.route(x, gate, bias, **kw)


def test_router_bias_selects_but_does_not_weigh():
    g = torch.Generator().manual_seed(0)
    x, gate = torch.randn(16, 32, generator=g), torch.randn(8, 32, generator=g)
    idx0, w0 = _route(x, gate, torch.zeros(8), norm_topk_prob=False,
                      scaling=1.0)
    bias = torch.zeros(8)
    bias[5] = 10.0   # expert 5 is chosen for every token
    idx1, w1 = _route(x, gate, bias, norm_topk_prob=False, scaling=1.0)
    assert (idx1 == 5).any(1).all() and not (idx0 == 5).all()
    scores = torch.sigmoid(x @ gate.t())
    # the weights are the unbiased scores of the chosen experts
    torch.testing.assert_close(w1, scores.gather(1, idx1))
    torch.testing.assert_close(w0, scores.gather(1, idx0))


def test_router_normalises_then_scales_in_float32():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(10, 32, generator=g).to(torch.bfloat16)
    gate = torch.randn(8, 32, generator=g).to(torch.bfloat16)
    idx, w = _route(x, gate, torch.zeros(8, dtype=torch.bfloat16))
    assert w.dtype == torch.float32
    torch.testing.assert_close(w.sum(-1), torch.full((10,), 2.446))
    # float32 logits of the bf16 operands, as the published router
    scores = torch.sigmoid(x.float() @ gate.float().t())
    want = scores.gather(1, idx)
    torch.testing.assert_close(w, want / want.sum(-1, keepdim=True) * 2.446)


def _experts_loop(x, idx, w, w1, w3, w2):
    out = torch.zeros_like(x)
    for e in range(w1.shape[0]):
        tok, slot = torch.where(idx == e)
        y = moe.swiglu(x[tok], w1[e], w3[e], w2[e])
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out


@pytest.mark.parametrize("skew", [False, True])
def test_experts_drop_no_token(skew):
    """The grouped products against a loop over experts by index; with
    ``skew`` every token routes to experts 0 and 1 (the others get none),
    and the counters see it."""
    g = torch.Generator().manual_seed(2)
    N, D, I, E = 24, 32, 16, 8
    x = torch.randn(N, D, generator=g)
    w1, w3 = torch.randn(E, I, D, generator=g), torch.randn(E, I, D,
                                                             generator=g)
    w2 = torch.randn(E, D, I, generator=g)
    gate = torch.randn(E, D, generator=g)
    bias = torch.zeros(E)
    if skew:
        bias[:2] = 100.0
    idx, w = _route(x, gate, bias)
    counts = torch.zeros(3, dtype=torch.int64)
    got = moe.experts(x, idx, w, w1, w3, w2, counts)
    torch.testing.assert_close(got, _experts_loop(x, idx, w, w1, w3, w2),
                               rtol=1e-5, atol=1e-5)
    hit = int((torch.bincount(idx.reshape(-1), minlength=E) > 0).sum())
    assert counts.tolist() == [N * 2, hit, int(torch.bincount(
        idx.reshape(-1)).max())]
    if skew:
        assert counts.tolist() == [N * 2, 2, N]


# ------------------------------------------------ kernel #12's twin


def _pool_and_rows(seed=3, B=2, ps=4, MP=6, L=2, dk=24):
    g = torch.Generator().manual_seed(seed)
    NP = 1 + B * MP
    pool = torch.randn((L, 1, NP, ps, dk), generator=g)
    table = torch.full((B, MP), -1, dtype=torch.int32)
    perm = torch.randperm(NP - 1, generator=g) + 1
    lengths = torch.tensor([9, 17], dtype=torch.int32)
    for b in range(B):
        n = -(-(int(lengths[b]) + 8) // ps)
        table[b, :n] = perm[b * MP:b * MP + n].to(torch.int32)
    return g, pool, table, lengths


def _plain(q, keys, scale, dv):
    s = torch.einsum("thd,nd->thn", q, keys) * scale
    return torch.einsum("thn,nd->thd", torch.softmax(s, -1), keys[:, :dv])


def _row_keys(pool, layer, table, b, n):
    ps = pool.shape[3]
    return torch.stack([pool[layer, 0, table[b, s // ps], s % ps]
                        for s in range(n)])


def test_mla_twins_match_plain_attention():
    """Both forms of #12's twin against softmax attention written out over
    each row's slots in order: decode stores the fresh latent then attends
    it; a chunk of 5 attends its cached slots and itself, causal."""
    dk, dv, H, layer, scale = 24, 16, 3, 1, 0.3
    g, pool, table, lengths = _pool_and_rows(dk=dk)
    q = torch.randn((2, H, dk), generator=g)
    fresh = torch.randn((2, dk), generator=g)
    out = mla.mla_decode(q, fresh, pool, table, lengths, layer, scale, dv)
    for b in range(2):
        n = int(lengths[b]) + 1
        keys = _row_keys(pool, layer, table, b, n)
        torch.testing.assert_close(keys[-1], fresh[b])
        torch.testing.assert_close(out[b], _plain(q[b][None], keys, scale,
                                                  dv)[0])
    T = 5
    qc = torch.randn((2, T, H, dk), generator=g)
    lat = torch.randn((2, T, dk), generator=g)
    mla.store_latents(pool, layer, mla.latent_slots(table, lengths, T, 4),
                      lat)
    out = mla.mla_chunk(qc, pool, table, lengths, layer, scale, dv)
    for b in range(2):
        for t in range(T):
            keys = _row_keys(pool, layer, table, b, int(lengths[b]) + t + 1)
            torch.testing.assert_close(
                out[b, t], _plain(qc[b, t][None], keys, scale, dv)[0])


def test_mla_decode_skips_dead_entries():
    """A retired row (all entries -1) stores nothing and gives 0."""
    dk, dv = 24, 16
    g, pool, table, lengths = _pool_and_rows(dk=dk)
    table[1] = -1
    before = pool.clone()
    out = mla.mla_decode(torch.randn((2, 2, dk), generator=g),
                         torch.randn((2, dk), generator=g), pool, table,
                         lengths, 0, 0.3, dv)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    changed = (pool != before).reshape(pool.shape[0], -1).any(1)
    assert changed.tolist() == [True, False]


# ------------------------------------------------------ refusals, mapping


@pytest.mark.parametrize("case", ["int8", "int4", "speculative", "shards"])
def test_engine_refuses_what_mla_does_not_bring(case):
    from v2pe_tpu_torch.parallel.context import ShardingContext, use_sharding

    cfg = _cfg()
    chat = ChatModel(_model(cfg), cfg, CodePointTokenizer(640))
    kw = dict(max_rows=2, max_len=64, page_size=8, chunk_size=16)
    if case in ("int8", "int4"):
        kw["kv_dtype"] = case
    if case == "speculative":
        kw["generation_config"] = GenerationConfig(speculative_k=3)
    if case == "shards":
        with use_sharding(ShardingContext(seq_shards=2)):
            with pytest.raises(ValueError, match="sharded"):
                InferenceEngine(chat, **kw)
        return
    with pytest.raises(ValueError, match="latent-attention"):
        InferenceEngine(chat, **kw)


def test_hf_config_and_names():
    """``vlm_config_from_hf`` takes a DeepseekV3ForCausalLM decoder, and
    ``hf_names`` covers every parameter but the stacked experts."""
    from v2pe_tpu_torch.core.config import vlm_config_from_hf

    hf = {"vision_config": {"hidden_size": 64, "num_hidden_layers": 2,
                            "num_attention_heads": 4, "image_size": 56,
                            "intermediate_size": 128},
          "llm_config": {"architectures": ["DeepseekV3ForCausalLM"],
                         "hidden_size": 64, "num_hidden_layers": 3,
                         "num_attention_heads": 4, "num_key_value_heads": 4,
                         "kv_lora_rank": 32, "q_lora_rank": None,
                         "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
                         "v_head_dim": 16, "n_routed_experts": 8,
                         "n_shared_experts": 2, "num_experts_per_tok": 2,
                         "moe_intermediate_size": 32, "vocab_size": 640,
                         "intermediate_size": 96, "rope_scaling": None,
                         "topk_method": "noaux_tc", "scoring_func": "sigmoid",
                         "routed_scaling_factor": 2.446}}
    cfg = vlm_config_from_hf(hf)
    assert decoder.is_mla(cfg.llm) and cfg.llm.latent_dim == 48
    assert cfg.llm.first_k_dense_replace == 1  # the class default
    names = params.hf_names(cfg)
    model = params._meta_model(cfg)
    left = {n for n, _ in model.named_parameters()} - set(names)
    assert all(".experts_w" in n or "embeddings.patch.weight" in n
               or "class_embedding" in n for n in left), sorted(left)[:5]
    bad = dict(hf, llm_config=dict(hf["llm_config"], q_lora_rank=64))
    with pytest.raises(ValueError, match="q_lora_rank"):
        vlm_config_from_hf(bad)
    bad = dict(hf, llm_config=dict(hf["llm_config"], n_group=8,
                                   topk_group=4))
    with pytest.raises(ValueError, match="grouped expert selection"):
        vlm_config_from_hf(bad)
