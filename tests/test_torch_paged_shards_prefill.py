"""The sequence-sharded paged pool against JAX on the CPU, continued from
``tests/test_torch_paged_shards.py`` (its helpers and shapes): the chunked
prefill over a sharded history against JAX's
``seq_sharded_chunked_prefill_attention`` under ``shard_map`` at seq 4 x
tensor 1 and 2, and a 5-token verify step across a page boundary through
``llm_forward`` over a 4-shard pool against unsharded JAX.

Tolerances: fp32 outputs 2e-5; layer 0's pool contents exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.core.config import VisionConfig, VLMConfig
from v2pe_tpu.infer import paged_kv as jpk
from v2pe_tpu.models.internlm2 import llm_forward as jax_llm_forward
from v2pe_tpu.models.params import init_vlm_params
from v2pe_tpu.ops import paged_attention as jpa
from v2pe_tpu_torch.infer import paged_kv as tpk
from v2pe_tpu_torch.models import internlm2
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.ops import paged_attention as tpa

from .test_torch_paged_shards import (LENGTHS, MP, N_SEQ, NP, PS, TOL, _cfg,
                                      _fresh, _halves, _jax_cache, _mesh,
                                      _pool_of, _t)
from .torch_parity import (jax_paged_cache, port_config, port_paged_cache,
                           to_numpy)


@pytest.mark.parametrize("tensor,kv", [(1, "int8"), (2, None)])
def test_seq_sharded_chunked_prefill_matches_jax(jax8, tensor, kv):
    """A 12-token chunk over the sharded history: the self part on shard 0
    only, each shard's sweep, the lse merge; against JAX's
    seq_sharded_chunked_prefill_attention (impl 'jnp')."""
    cfg = _cfg()
    cache = _jax_cache(cfg, LENGTHS, 4, kv_dtype=kv)
    q, k, v = _fresh(cfg, len(LENGTHS), 12, 7)
    seg = np.ones((len(LENGTHS), 12), np.int32)
    seg[1, 9:] = 0
    ref = jpa.seq_sharded_chunked_prefill_attention(
        _mesh(tensor), "seq", "tensor", jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(seg), cache.k_pages, cache.v_pages,
        cache.page_table, cache.lengths, jnp.int32(1), impl="jnp",
        interpret=True, k_scales=cache.k_scales, v_scales=cache.v_scales)
    t = port_paged_cache(cache)
    views = tpk.shard_views(t)
    out = torch.empty(q.shape)
    for qh, kh in _halves(tensor, cfg.num_attention_heads,
                          cfg.num_key_value_heads):
        kp, vp, ks, vs = _pool_of(t, kh)
        out[:, :, qh] = tpa.seq_sharded_chunked_prefill_attention(
            _t(q)[:, :, qh].contiguous(), _t(k)[:, :, kh].contiguous(),
            _t(v)[:, :, kh].contiguous(), _t(seg), kp, vp, views, t.lengths,
            1, k_scales=ks, v_scales=vs)
    keep = seg.astype(bool)  # padded queries are nobody's output
    np.testing.assert_allclose(to_numpy(out)[keep], np.asarray(ref)[keep],
                               atol=TOL, rtol=TOL)


def test_verify_step_across_page_boundary_matches_unsharded():
    """A T = 5 step (a speculative verify) whose tokens cross from one page
    to the next, hence from shard s to shard s + 1: llm_forward over the
    4-shard pool gives JAX's unsharded logits, and both shards' pages hold
    the tokens' k/v as the unsharded pool does (layer 0's bit for bit)."""
    vcfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14), llm=_cfg())
    cfg, pcfg = vcfg.llm, port_config(vcfg.llm)
    vparams = init_vlm_params(jax.random.PRNGKey(0), vcfg)
    layers = dict(vparams["llm"]["layers"])  # scores far from uniform
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**vparams["llm"], "layers": layers}
    llm = from_jax_params(jax.tree.map(np.asarray,
                                       {**vparams, "llm": params}),
                          port_config(vcfg)).llm
    lens = torch.tensor([13, 6], dtype=torch.int32)  # 13 + 5 crosses slot 16
    ids = torch.from_numpy(np.random.RandomState(8).randint(0, 256, (2, 18)))
    seg = (torch.arange(13)[None] < lens[:, None]).to(torch.int32)
    five = torch.full((2,), 5, dtype=torch.int32)
    pos = lens[:, None].float() + torch.arange(5.0)[None]
    logits, pools = {}, {}
    for n in (1, N_SEQ):
        t = tpk.PagedKVCache.zeros(pcfg, 2, NP, PS, MP, dtype=torch.float32,
                                   n_shards=n)
        t = tpk.allocate_rows(t, lens)
        with torch.no_grad():
            _, t = internlm2.llm_forward(
                llm, pcfg, input_ids=ids[:, :13], segment_ids=seg,
                rope_pos_ids=torch.arange(13.0).expand(2, 13), paged_cache=t)
        t = dataclasses.replace(t, lengths=lens.clone())
        if n == 1:
            prefix = jax_paged_cache(t)
        t = tpk.allocate_rows(t, five)
        with torch.no_grad():
            lg, t = internlm2.llm_forward(llm, pcfg, input_ids=ids[:, 13:],
                                          rope_pos_ids=pos, paged_cache=t)
        logits[n] = to_numpy(lg)
        # layer 0's k/v come from the embeddings alone: equal bits
        k, v, valid = tpk.gather_row_kv(tpk.advance_lengths(t, five), 0)
        pools[n] = [to_numpy(x)[to_numpy(valid)] for x in (k, v)]
    pt = to_numpy(t.page_table)
    assert pt[0, 1] // (NP // N_SEQ) == 1 and pt[0, 2] // (NP // N_SEQ) == 2
    ref, _ = jax_llm_forward(
        params, cfg, input_ids=jnp.asarray(ids[:, 13:].numpy()),
        rope_pos_ids=jnp.asarray(pos.numpy()),
        paged_cache=jpk.allocate_rows(prefix, jnp.full((2,), 5, jnp.int32)),
        attn_impl="jnp")
    for n in (1, N_SEQ):
        np.testing.assert_allclose(logits[n], np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    for a, b in zip(pools[N_SEQ], pools[1]):
        np.testing.assert_array_equal(a, b)
