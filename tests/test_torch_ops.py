"""Parity of the PyTorch port's ops (v2pe_tpu_torch/ops) with the JAX
package on the CPU: rotary, norms, reference attention, and the flash
kernel's plain twin against JAX flash attention (jnp and Pallas-interpret;
in bf16 against the Pallas kernel's precision="bf16all").
The CUDA kernel itself is checked against the twin on the card by
chip_smoke.py."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from v2pe_tpu.ops import attention as jattn
from v2pe_tpu.ops import attention_ref as jref
from v2pe_tpu.ops import norms as jnorms
from v2pe_tpu.ops import rope as jrope
from v2pe_tpu.ops.flash_pallas import flash_attention_fwd_pallas
from v2pe_tpu_torch.ops import attention as tattn
from v2pe_tpu_torch.ops import attention_ref as tref
from v2pe_tpu_torch.ops import flash_fwd
from v2pe_tpu_torch.ops import norms as tnorms
from v2pe_tpu_torch.ops import rope as trope

from .torch_parity import run_parity, to_numpy

THETA = 1e6


def _v2pe_ids(B, S, seed=0):
    """Fractional V2PE-style ids: integer text steps with a run of 1/4
    steps (visual tokens at stride 64 over 256)."""
    step = np.ones((B, S), np.float32)
    step[:, S // 4:S // 2] = 0.25
    return (np.cumsum(step, axis=1) - 1 +
            np.random.default_rng(seed).integers(0, 3, (B, 1))
            ).astype(np.float32)


def test_port_imports_without_jax():
    # the card's machine has no jax, and may lack PIL, transformers and
    # tokenizers: neither the port nor chip_smoke.py may need them, and the
    # port needs nothing of the JAX package (its host modules are its own)
    code = ("import sys, chip_smoke, v2pe_tpu_torch, "
            "v2pe_tpu_torch.ops.attention, v2pe_tpu_torch.ops._build, "
            "v2pe_tpu_torch.ops.paged_attention, "
            "v2pe_tpu_torch.ops.quantized_matmul, "
            "v2pe_tpu_torch.models.params, v2pe_tpu_torch.infer.chat, "
            "v2pe_tpu_torch.infer.streaming, v2pe_tpu_torch.infer.paged_kv, "
            "v2pe_tpu_torch.infer.chunked_prefill, "
            "v2pe_tpu_torch.infer.session, v2pe_tpu_torch.serve.mm_utils, "
            "v2pe_tpu_torch.serve.worker, v2pe_tpu_torch.ops.flash_bwd, "
            "v2pe_tpu_torch.core.checkpoint, v2pe_tpu_torch.train.adam8bit, "
            "v2pe_tpu_torch.train.optimizer, v2pe_tpu_torch.train.synth, "
            "v2pe_tpu_torch.train.metrics, v2pe_tpu_torch.train.train_step, "
            "v2pe_tpu_torch.train.trainer, v2pe_tpu_torch.train.cli, "
            "v2pe_tpu_torch.core.config, v2pe_tpu_torch.positional, "
            "v2pe_tpu_torch.data.datasets, v2pe_tpu_torch.data.packing, "
            "v2pe_tpu_torch.data.object_store, v2pe_tpu_torch.native, "
            "v2pe_tpu_torch.parallel.context, v2pe_tpu_torch.parallel.ring, "
            "v2pe_tpu_torch.parallel.ring_fused, "
            "v2pe_tpu_torch.parallel.ulysses, "
            "v2pe_tpu_torch.parallel.shard_attn, "
            "v2pe_tpu_torch.evalkit.mm_niah_long\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'v2pe_tpu', 'PIL', 'transformers', 'tokenizers')]\n"
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports the port (whose host modules are its own
    copies), never ``v2pe_tpu`` or ``jax``."""
    import ast
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "v2pe_tpu_torch" in roots
    assert not roots & {"v2pe_tpu", "jax"}, sorted(roots)


@pytest.mark.parametrize("mode", ["v2pe", "linear", "dynamic_short",
                                  "dynamic_long"])
def test_rope_matches_jax(mode):
    B, S, H, D = 2, 96, 3, 64
    ids = _v2pe_ids(B, S)
    x = np.random.default_rng(1).standard_normal((B, S, H, D)).astype(
        np.float32)
    kw = dict(mode=mode.split("_")[0], scaling_factor=2.0,
              max_position_embeddings=64,
              seq_len={"dynamic_short": 32}.get(mode, S))

    def run(lib, rope):
        def fn(pos, x):
            sp, base = rope.scale_positions(pos, D, THETA, **kw)
            cos, sin = rope.compute_rope_cos_sin(sp, D, base)
            return sp, cos, sin, rope.apply_rotary(x, cos, sin), \
                rope.rope_inv_freq(D, THETA), rope._rotate_half(x)
        return fn

    p = run_parity(run(jnp, jrope), run(torch, trope), ids, x)
    p.assert_close(atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 7, 48)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p = run_parity(
        lambda x, w, b: (jnorms.rms_norm(x.astype(jd), w.astype(jd), 1e-5),
                         jnorms.layer_norm(x.astype(jd), w.astype(jd),
                                           b.astype(jd), 1e-6)),
        lambda x, w, b: (tnorms.rms_norm(x.to(td), w.to(td), 1e-5),
                         tnorms.layer_norm(x.to(td), w.to(td), b.to(td),
                                           1e-6)),
        x, w, b)
    # bf16: one rounding of each side lands at most an ulp (2^-8) apart
    tol = 1e-5 if dtype == "float32" else 1e-2
    p.assert_close(atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["segments_causal", "positions_gqa",
                                  "offsets", "bidirectional"])
def test_attention_reference_matches_jax(case):
    rng = np.random.default_rng(3)
    B, Sq, Sk, Hq, Hkv, D = 2, 24, 40, 4, 2, 16
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    seg_q = np.repeat([[1] * 12 + [2] * 12], B, 0).astype(np.int32)
    seg_k = np.repeat([[1] * 20 + [2] * 16 + [0] * 4], B, 0).astype(np.int32)
    pos_q = np.broadcast_to(np.arange(16, 40, dtype=np.int32), (B, Sq))
    pos_k = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    kw = {"segments_causal": dict(causal=True),
          "positions_gqa": dict(causal=True),
          "offsets": dict(causal=True, q_offset=16),
          "bidirectional": dict(causal=False)}[case]

    def run(ref):
        def fn(q, k, v, sq, sk, pq, pk):
            extra = dict(q_positions=pq, kv_positions=pk) \
                if case == "positions_gqa" else {}
            segs = dict(q_segment_ids=sq, kv_segment_ids=sk) \
                if case != "offsets" else {}
            mask = ref.make_attention_mask(sq, sk, causal=True,
                                           q_positions=pq, kv_positions=pk)
            return ref.attention_reference(q, k, v, **segs, **extra, **kw), \
                mask
        return fn

    p = run_parity(run(jref), run(tref), q, k, v, seg_q, seg_k, pos_q, pos_k)
    p.assert_close(atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ flash forms

BASE_FORMS = ["packed_causal", "bidirectional_kpad", "cross_positions",
              "fused_qrope", "fused_qkrope", "dead_row"]
# each form at head dim 32 and again at Phi-3's 96 (the fused rotary then
# pairs d with d + 48)
FORMS = BASE_FORMS + [f"{f}_hd96" for f in BASE_FORMS]


def _flash_case(form):
    """(q, k, v, seg_q, seg_k, pos_q, pos_k, rope_ids, causal, explicit
    positions, rope mode) for one form of the kernel (head dim 32, or 96
    for a form named ``*_hd96``)."""
    rng = np.random.default_rng(4)
    form, hd96, _ = form.partition("_hd96")
    B, Hq, Hkv, D = 2, 4, 2, 96 if hd96 else 32
    Sq = Sk = 150
    if form == "cross_positions":
        Sq, Sk = 64, 192
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    packed = np.zeros((B, Sq), np.int32)
    packed[:, :50], packed[:, 50:75], packed[:, 75:133] = 1, 2, 3
    pos_q = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    pos_k = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    seg_q, seg_k = packed, packed.copy()
    causal, explicit, rope = True, False, None
    if form == "bidirectional_kpad":
        seg_q = np.ones((B, Sq), np.int32)
        seg_k = np.ones((B, Sk), np.int32)
        seg_k[:, 131:] = 0
        causal = False
    elif form == "cross_positions":
        # a dense-cache prefill: queries at the end of a right-padded cache
        seg_q = np.ones((B, Sq), np.int32)
        seg_k = np.ones((B, Sk), np.int32)
        seg_k[0, 180:] = 0
        pos_q = pos_q + 110
        explicit = True
    elif form in ("fused_qrope", "fused_qkrope"):
        rope = "q" if form == "fused_qrope" else "qk"
    elif form == "dead_row":
        seg_q = packed.copy()
        seg_q[:, 60:70] = 9  # a segment no key carries
    ids = _v2pe_ids(B, Sq)
    return q, k, v, seg_q, seg_k, pos_q, pos_k, ids, causal, explicit, rope


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("form", FORMS)
def test_flash_twin_matches_jax(form, impl):
    (q, k, v, seg_q, seg_k, pos_q, pos_k, ids, causal, explicit,
     rope) = _flash_case(form)

    def run(lib, attn, **extra):
        def fn(q, k, v, sq, sk, pq, pk, ids):
            kw = dict(q_positions=pq, kv_positions=pk) if explicit else {}
            if rope:
                kw["rope_positions"] = (ids, ids if rope == "qk" else None,
                                        THETA)
            return attn.flash_attention(q, k, v, q_segment_ids=sq,
                                        kv_segment_ids=sk, causal=causal,
                                        **kw, **extra)
        return fn

    p = run_parity(run(jnp, jattn, impl=impl, block_q=64, block_k=64),
                   run(torch, tattn), q, k, v, seg_q, seg_k, pos_q, pos_k,
                   ids)
    p.assert_close(atol=2e-5, rtol=2e-5)
    if form.startswith("dead_row"):
        assert np.all(p.torch[0][:, 60:70] == 0)


@pytest.mark.parametrize("form", FORMS)
def test_flash_twin_lse_matches_pallas(form):
    (q, k, v, seg_q, seg_k, pos_q, pos_k, ids, causal, explicit,
     rope) = _flash_case(form)
    rope_kw = lambda r: dict(rope_q=r, rope_k=r if rope == "qk" else None,
                             rope_theta=THETA) if rope else {}
    scale = q.shape[-1] ** -0.5
    p = run_parity(
        lambda *a: flash_attention_fwd_pallas(
            *a[:7], causal=causal, scale=scale, block_q=64, block_k=64,
            ordered=not explicit, interpret=True, **rope_kw(a[7])),
        lambda *a: flash_fwd.flash_attention_fwd(
            *a[:7], causal=causal, scale=scale, **rope_kw(a[7])),
        q, k, v, seg_q, seg_k, pos_q, pos_k, ids)
    p.assert_close(atol=2e-5, rtol=2e-5)
    lse = p.torch[1]
    dead = (seg_q == 0) | (seg_q == 9)
    assert np.all(lse.transpose(0, 2, 1)[dead] == np.float32(
        flash_fwd.NEG_INF))


def _rotation_flip_bound(q, k, ids, rope, scale) -> float:
    """The largest change of any score between the operands the two
    packages give the bf16 tensor cores: each rotates q (and, with "qk", k)
    in fp32 by its own angle formula (the Pallas kernel's ``_rope_block``,
    the port's ``_apply_rope``) and rounds it once to bf16; where the two
    fp32 values straddle a rounding boundary the operands differ by a bf16
    step. lse, a log-sum-exp of the scores, moves by at most this much."""
    from v2pe_tpu.ops.flash_pallas import _rope_block

    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    bf = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                              .astype(jnp.float32), np.float64)
    x16 = [bf(x) for x in (q, k)]  # the bf16 inputs, as both take them

    def jax_rot(x):
        return np.stack([np.stack([np.asarray(_rope_block(
            jnp.asarray(x[b, :, h], jnp.float32), jnp.asarray(ids[b])[:, None],
            THETA)) for h in range(x.shape[2])], 1) for b in range(B)])

    rk = rope == "qk"
    pq, pk = flash_fwd._apply_rope(
        torch.from_numpy(x16[0]).float(), torch.from_numpy(x16[1]).float(),
        torch.from_numpy(ids), torch.from_numpy(ids) if rk else None, THETA)
    port = [bf(pq.numpy()), bf(pk.numpy())]
    jaxs = [bf(jax_rot(x16[0])), bf(jax_rot(x16[1])) if rk else x16[1]]
    scores = [np.einsum("bqhgd,bkhd->bhgqk",
                        x[0].reshape(B, S, Hq // G, G, D), x[1])
              for x in (port, jaxs)]
    return float(scale * np.abs(scores[0] - scores[1]).max())


@pytest.mark.parametrize("form", FORMS)
def test_flash_twin_bf16_matches_pallas_bf16all(form):
    """bf16 q/k/v: the plain version rounds where the kernel's tensor cores
    do, which are the Pallas kernel's precision="bf16all" points. The scale
    is a power of two here, so scaling q before its rounding (Pallas) and
    scaling the fp32 scores (the port) give the same products."""
    (q, k, v, seg_q, seg_k, pos_q, pos_k, ids, causal, explicit,
     rope) = _flash_case(form)
    rope_kw = lambda r: dict(rope_q=r, rope_k=r if rope == "qk" else None,
                             rope_theta=THETA) if rope else {}
    scale = 0.25
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    want = flash_attention_fwd_pallas(
        jq, jk, jv, *map(jnp.asarray, (seg_q, seg_k, pos_q, pos_k)),
        causal=causal, scale=scale, block_q=64, block_k=64,
        ordered=not explicit, interpret=True, precision="bf16all",
        **rope_kw(jnp.asarray(ids)))
    got = flash_fwd.flash_attention_fwd(
        tq, tk, tv, *map(torch.from_numpy, (seg_q, seg_k, pos_q, pos_k)),
        causal=causal, scale=scale, **rope_kw(torch.from_numpy(ids)))
    assert got[0].dtype == torch.bfloat16
    (wo, wl), (go, gl) = ([np.asarray(to_numpy(x), np.float64) for x in y]
                          for y in (want, got))
    # out: Pallas rounds P against the running max of its 64-key blocks,
    # the plain version against the row's final max, and both round out to
    # bf16: one bf16 step (2^-7 at |out| < 4) each, at most
    np.testing.assert_allclose(go, wo, atol=2.0 ** -6, rtol=0)
    # lse sums the unrounded fp32 weights in both: fp32 sums in another
    # order. With rotary, the packages compute the angles by different fp32
    # formulas, which moves a few rotated elements to the neighbouring bf16
    # value; each such flip moves a score by one bf16 step of
    # scale * q_i * k_i (~1e-3 at most for these unit-normal inputs at head
    # dim 32). At head dim 96 a score sums three times the rotated elements,
    # and the limit is the largest score change the flips of this input
    # make (_rotation_flip_bound: lse moves by at most that much)
    tol = 2e-5
    if rope:
        tol = 1e-3 if q.shape[-1] == 32 else \
            _rotation_flip_bound(q, k, ids, rope, scale) + 2e-5
    np.testing.assert_allclose(gl, wl, atol=tol, rtol=0)
    if form.startswith("dead_row"):
        assert np.all(go[:, 60:70] == 0)


def test_flash_with_lse_and_decode_path_match_jax():
    rng = np.random.default_rng(5)
    B, Hq, Hkv, D = 2, 4, 2, 16
    q = rng.standard_normal((B, 80, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, 80, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, 80, Hkv, D)).astype(np.float32)
    seg = np.ones((B, 80), np.int32)
    seg[1, 70:] = 0
    ids = _v2pe_ids(B, 80)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (B, 80)).copy()

    def run(attn, **extra):
        def fn(q, k, v, seg, ids, pos):
            out, lse = attn.flash_attention_with_lse(
                q, k, v, q_segment_ids=seg, kv_segment_ids=seg, **extra)
            # decode: 4 fresh queries over 80 keys take the einsum route,
            # with the rotary applied outside the kernel
            dec = attn.flash_attention(
                q[:, -4:], k, v, q_segment_ids=seg[:, -4:],
                kv_segment_ids=seg, q_positions=pos[:, -4:],
                kv_positions=pos, rope_positions=(ids[:, -4:], ids, THETA))
            return out, lse, dec
        return fn

    p = run_parity(run(jattn, impl="jnp"), run(tattn), q, k, v, seg, ids,
                   pos)
    p.assert_close(atol=2e-5, rtol=2e-5)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    B, S, H, D = 1, 8, 2, 64
    q = torch.zeros(B, S, H, D)
    vec = torch.zeros(B, S, dtype=torch.int32)
    ok = (q, q, q, vec, vec, vec, vec, None, None)
    flash_fwd._check(*ok)  # accepted
    for hd in (96, 128):  # Phi-3's head dim and InternLM2's
        flash_fwd._check(*(torch.zeros(B, S, H, hd),) * 3, *ok[3:])
    bad = {
        "head dim": (torch.zeros(B, S, H, 32),) * 3 + ok[3:],
        "head dim 80": (torch.zeros(B, S, H, 80),) * 3 + ok[3:],
        "dtype": (q.half(), q.half(), q.half()) + ok[3:],
        "mixed dtypes": (q, q.bfloat16(), q) + ok[3:],
        "non-contiguous": (q.transpose(1, 2).contiguous().transpose(1, 2),
                           q, q) + ok[3:],
        "segment dtype": ok[:3] + (vec.long(),) + ok[4:],
        "gqa": (torch.zeros(B, S, 3, D), q, q) + ok[3:],
        "rope ids": ok[:7] + (torch.zeros(B, S, dtype=torch.int32), None),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            flash_fwd._check(*args)
    # a tensor on neither the CPU nor a CUDA device is refused, not run
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no flash kernel"):
        flash_fwd.flash_attention_fwd(meta, meta, meta, vec, vec, vec, vec,
                                      causal=True, scale=1.0)
