"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --profile        # only a torch.profiler breakdown
                                           # of the 8-tile request's generate
    python3 chip_smoke.py --profile-train  # only a torch.profiler breakdown
                                           # of one full-width train step

Phases, each of which fails the run (nonzero exit, no result line):
  1. device: the card's name and power limit, torch/CUDA versions, and the
     build of the CUDA kernels from this checkout's sources;
  2. kernels: every kernel against its plain PyTorch twin at every form
     the serving paths give it, with errors and times: the flash forward;
     the paged store, decode and prefill kernels in bf16 and int8 (the
     served rows, one row over 32k tokens at ChatModel's page 128, the
     session's store and decode over a 34k context at page 512, a
     2048-token chunk over a 32k history);
  3. serve: InternVL2-2B at full width (bf16, random weights from a seed)
     answers three chat requests through ChatModel.batch_chat, and the
     flash kernel's launch count shows the path went through it;
  4. stream: stream_generate's tokens equal generate's greedy tokens;
  5. packed: one packed 8192-token forward with 8 image tiles;
  6. paged serve: the same requests through a paged ChatModel (TTFT and
     decode rate, bf16 and int8 pools), paged stream equal to paged
     generate, paged logits held against dense;
  7. session: a three-turn ChatSession (an 8-tile image, two text turns
     over the pool, turn 2 held against a full re-prefill) and a timed
     2k-token turn over a 32k-token history;
  8. worker: the HTTP ModelWorker on 127.0.0.1 answers the status route,
     /worker_generate_stream and /v1/chat/completions (SSE) with the text
     ChatModel.chat gives;
  9. train: InternVL2-2B at full width trains 4 steps through
     trainer.train on 8192 packed tokens with 8 tiles (remat 'full', int8
     Adam), then saves a checkpoint asynchronously; every step launches
     the forward kernel 96 times and each backward kernel 48 times;
 10. bench recipe: make_train_step called directly, as bench.py's
     training bench does, on the port's make_synthetic_batch (8192
     tokens, 8 tiles, stride 64): three steps, the same launch counts.
Phase 2 also holds the two flash-backward kernels against their twin at
the training path's forms (the 8192-token packed LLM, 8 ViT tiles, a
ragged fp32 form). A small fp32 model on the card against the same model
on the CPU (the kernels against their twins: a packed forward, then the
paged path with identical tokens, then one train step and a checkpoint
resume) runs after phase 2. Phases 3 and 6-10 each zero the kernels' launch
counts before they start and read them after, and fail if a kernel of
their path was not launched. The kernel table prints as one JSON line,
then the card line, then the last line {"ok": true, "device": {...}}.

Imports neither jax nor the JAX package, nor PIL/transformers/tokenizers:
the pixels come from numpy and the text from a code-point tokenizer.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = {  # max abs error of kernel against twin (twin in fp32)
    torch.bfloat16: {"out": 2e-2, "lse": 1e-3},
    torch.float32: {"out": 1e-4, "lse": 1e-4},
}
KERNEL_SOURCES = {
    "flash_fwd": "v2pe_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd_dkv": "v2pe_tpu_torch/csrc/flash_bwd.cu",
    "flash_bwd_dq": "v2pe_tpu_torch/csrc/flash_bwd.cu",
    "paged_store": "v2pe_tpu_torch/csrc/paged_attention.cu",
    "paged_decode": "v2pe_tpu_torch/csrc/paged_attention.cu",
    "paged_prefill": "v2pe_tpu_torch/csrc/paged_attention.cu",
}
KERNEL_REPLACES = {  # the Pallas kernel bodies
    "flash_fwd": "v2pe_tpu/ops/flash_pallas.py:68",
    "flash_bwd_dkv": "v2pe_tpu/ops/flash_pallas_bwd.py:72",
    "flash_bwd_dq": "v2pe_tpu/ops/flash_pallas_bwd.py:137",
    "paged_store": "v2pe_tpu/ops/paged_attention.py:58",
    "paged_decode": "v2pe_tpu/ops/paged_attention.py:187",
    "paged_prefill": "v2pe_tpu/ops/paged_attention.py:433",
}
MAX_NEW = 32
PACKED_LEN = 8192
REQUESTS = [  # (image tiles, question) of the served requests
    (8, "<image>\nDescribe the image in detail."),
    (1, "<image>\nWhat is shown here?"),
    (0, "请用一句话介绍你自己。"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_launches() -> None:
    """Zero every kernel's launch count (just before a path is driven)."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd
    from v2pe_tpu_torch.ops import paged_attention as pa

    flash_fwd.LAUNCHES = 0
    for counts in (pa.LAUNCHES, flash_bwd.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    """Every kernel's launch count (just after a path was driven)."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd
    from v2pe_tpu_torch.ops import paged_attention as pa

    torch.cuda.synchronize()
    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES,
            **pa.LAUNCHES}


def require(counts: dict, names, where: str) -> None:
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"{where}: no launch of {missing} ({counts})")


# ---------------------------------------------------------------- phase 1


def phase_device() -> None:
    from v2pe_tpu_torch.ops import _build

    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    path = _build.build()
    log(f"kernel build: {_build.build_seconds:.2f}s compile, "
        f"{time.perf_counter() - t0:.2f}s total -> {path}")


# ---------------------------------------------------------------- phase 2


def kernel_forms(device, prompt_lens, packed: dict):
    """(name, args, kwargs) of every form the serving path launches, at
    its shapes: ViT tiles of the image requests, the dense-cache prefill of
    each request (prompt over prompt + MAX_NEW slots), the packed forward
    (its segments and V2PE ids), and a ragged fp32/bf16 form with padded
    rows and both q and k rotated in-kernel."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    def arange(B, S):
        return torch.arange(S, dtype=torch.int32,
                            device=device).expand(B, S).contiguous()

    def ones(B, S):
        return torch.ones(B, S, dtype=torch.int32, device=device)

    forms = []
    for tiles in sorted({t for t, _ in REQUESTS if t}, reverse=True):
        B, S = tiles, 1025  # ViT: bidirectional, MHA, D=64
        forms.append((f"vit_tiles_{B}x{S}_bf16", (
            randn(B, S, 16, 64), randn(B, S, 16, 64), randn(B, S, 16, 64),
            ones(B, S), ones(B, S), arange(B, S), arange(B, S)),
            dict(causal=False, scale=64 ** -0.5)))
    for Sq in prompt_lens:
        Sk = Sq + MAX_NEW
        kv_seg = (arange(1, Sk) < Sq).int()
        forms.append((f"dense_prefill_{Sq}x{Sk}_bf16", (
            randn(1, Sq, 16, 128), randn(1, Sk, 8, 128), randn(1, Sk, 8, 128),
            ones(1, Sq), kv_seg, arange(1, Sq), arange(1, Sk)),
            dict(causal=True, scale=128 ** -0.5)))
    seg = packed["segment_ids"].to(device)
    S = seg.shape[1]
    forms.append((f"packed_{S}_3seg_qrope_bf16", (
        randn(1, S, 16, 128), randn(1, S, 8, 128), randn(1, S, 8, 128),
        seg, seg, arange(1, S), arange(1, S)),
        dict(causal=True, scale=128 ** -0.5,
             rope_q=packed["rope_pos_ids"].to(device), rope_k=None,
             rope_theta=1e6)))
    S = 150  # 2 segments and a padded tail: rows that attend nothing
    seg = torch.zeros(2, S, dtype=torch.int32, device=device)
    seg[:, :60], seg[:, 60:110] = 1, 2
    ids = torch.cat([torch.arange(20.0), 19 + 0.25 * torch.arange(1, 41),
                     29 + torch.arange(1, 91.0)]).to(device).expand(2, S)
    for dt, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        forms.append((f"ragged_{S}_padded_qkrope_{tag}", (
            randn(2, S, 16, 128, dtype=dt), randn(2, S, 8, 128, dtype=dt),
            randn(2, S, 8, 128, dtype=dt), seg, seg, arange(2, S),
            arange(2, S)), dict(causal=True, scale=128 ** -0.5,
                                rope_q=ids.contiguous(),
                                rope_k=ids.contiguous(), rope_theta=1e6)))
    return forms


def phase_kernels(prompt_lens, packed: dict) -> list:
    """Kernel against twin at every form; returns per-form records."""
    from v2pe_tpu_torch.ops import flash_fwd

    device = torch.device("cuda")
    records = []
    for name, args, kw in kernel_forms(device, prompt_lens, packed):
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        torch.cuda.synchronize()
        up = [a.float() if a.is_floating_point() and a.ndim == 4 else a
              for a in args]
        ref_out, ref_lse = flash_fwd.flash_attention_fwd_torch(*up, **kw)
        err_out = (out.float() - ref_out).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = TOL[args[0].dtype]
        ms = time_ms(lambda: flash_fwd.flash_attention_fwd(*args, **kw))
        plain_ms = time_ms(
            lambda: flash_fwd.flash_attention_fwd_torch(*args, **kw))
        log(f"kernel {name}: max|out-twin| {err_out:.3e} (tol {tol['out']})"
            f" max|lse-twin| {err_lse:.3e} (tol {tol['lse']}) "
            f"kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
        if not (torch.isfinite(out).all() and err_out <= tol["out"]
                and err_lse <= tol["lse"]):
            raise AssertionError(f"kernel disagrees with twin at {name}")
        records.append(dict(form=name, max_abs_err=max(err_out, err_lse),
                            ms=ms, plain_ms=plain_ms))
    return records


# ------------------------------------------------------ phase 2b: paged


PAGED_TOL = {  # kernel against twin (twin in fp32)
    # max |out - twin| / max |twin|: rounding a bf16 output moves each value
    # by at most 2^-8 of the largest; one bf16 step (2^-7) is the limit
    "out_rel": 2.0 ** -7,
    "lse": 1e-3,  # max abs; fp32 in both
    # store: max abs over the written pool (values and int8 scales) against
    # the twin run on CPU copies of the same inputs, which is jnp's exact
    # quantization: every element the same
    "store": 0.0,
}
LLM_L, LLM_HKV, LLM_HQ, LLM_HD = 24, 8, 16, 128  # InternVL2-2B's decoder
SESSION_CONTEXT = 34165  # tokens in the pool where the session decodes


def _pool(L, NP, ps, int8: bool, g, device):
    shape = (L, LLM_HKV, NP, ps, LLM_HD)
    if not int8:
        k, v = (torch.randn(shape, generator=g, device=device,
                            dtype=torch.bfloat16) for _ in range(2))
        return dict(k_pages=k, v_pages=v)
    k, v = (torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:3] + (1, ps), generator=g, device=device)
              * 0.025 + 0.005 for _ in range(2))
    return dict(k_pages=k, v_pages=v, k_scales=ks, v_scales=vs)


def _rows(lengths, ps, extra, device):
    """Page tables of rows holding ``lengths`` (+ extra) tokens, pages
    dealt out row after row from page 1 as allocate_rows does."""
    MP = max(-(-(n + extra) // ps) for n in lengths)
    table = torch.full((len(lengths), MP), -1, dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lengths):
        need = -(-(n + extra) // ps)
        table[b, :need] = torch.arange(nxt, nxt + need)
        nxt += need
    return table.to(device), nxt


def paged_forms(device, prompt_lens):
    """(kernel, name, fn, kwargs) of every form the paged path launches, at
    its shapes: the store and the fresh_in_pages decode over the served
    rows (mid-decode, page 128), decode of one row over 32k tokens (page
    128, ChatModel's), the separate-fresh decode at T=4, the session's
    store and decode of one row over a 34k context at page 512 (on one
    pool: the decode reads the stored token), and a 2048-token chunk over
    a 32k history at page 512; each in bf16 and int8."""
    from v2pe_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=device).manual_seed(11)
    forms = []
    served = [n + MAX_NEW // 2 for n in prompt_lens]
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"

        def q(B, T, H=LLM_HQ):
            return torch.randn((B, T, H, LLM_HD), generator=g, device=device,
                               dtype=torch.bfloat16)

        table, NP = _rows(served, 128, MAX_NEW, device)
        lens = torch.tensor(served, dtype=torch.int32, device=device)
        pool = _pool(LLM_L, NP, 128, int8, g, device)
        forms.append(("paged_store", f"store_B3_ps128_{tag}",
                      pa.store_fresh_token,
                      dict(k_new=q(3, 1, LLM_HKV), v_new=q(3, 1, LLM_HKV),
                           page_table=table, lengths=lens, layer=LLM_L - 1,
                           **pool)))
        forms.append(("paged_decode",
                      f"decode_fresh_in_pages_{'_'.join(map(str, served))}"
                      f"_ps128_{tag}", pa.paged_decode_attention,
                      dict(q=q(3, 1), k_new=None, v_new=None,
                           page_table=table, lengths=lens, layer=LLM_L - 1,
                           fresh_in_pages=True, return_lse=True, **pool)))
        forms.append(("paged_decode", f"decode_separate_T4_B3_ps128_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(3, 4), k_new=q(3, 4, LLM_HKV),
                           v_new=q(3, 4, LLM_HKV), page_table=table,
                           lengths=lens, layer=LLM_L - 1, return_lse=True,
                           **pool)))
        n32 = 32767
        table, NP = _rows([n32], 128, 1, device)
        pool = _pool(LLM_L, NP, 128, int8, g, device)
        forms.append(("paged_decode", f"decode_32k_B1_ps128_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(1, 1), k_new=None, v_new=None,
                           page_table=table,
                           lengths=torch.tensor([n32], dtype=torch.int32,
                                                device=device),
                           layer=LLM_L - 1, fresh_in_pages=True,
                           return_lse=True, **pool)))
        n = SESSION_CONTEXT
        table, NP = _rows([n], 512, 1, device)
        pool = _pool(LLM_L, NP, 512, int8, g, device)
        lens = torch.tensor([n], dtype=torch.int32, device=device)
        forms.append(("paged_store", f"store_B1_{n}_ps512_{tag}",
                      pa.store_fresh_token,
                      dict(k_new=q(1, 1, LLM_HKV), v_new=q(1, 1, LLM_HKV),
                           page_table=table, lengths=lens, layer=LLM_L - 1,
                           **pool)))
        forms.append(("paged_decode", f"decode_{n}_B1_ps512_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(1, 1), k_new=None, v_new=None,
                           page_table=table, lengths=lens, layer=LLM_L - 1,
                           fresh_in_pages=True, return_lse=True, **pool)))
        table, NP = _rows([32768], 512, 2048, device)
        pool = _pool(LLM_L, NP, 512, int8, g, device)
        forms.append(("paged_prefill", f"prefill_2048_over_32k_ps512_{tag}",
                      pa.paged_prefill_attention,
                      dict(q=q(1, 2048), page_table=table,
                           lengths=torch.tensor([32768], dtype=torch.int32,
                                                device=device),
                           layer=LLM_L - 1, **pool)))
    return forms


def _twin(kernel: str):
    from v2pe_tpu_torch.ops import paged_attention as pa

    return {"paged_store": pa.store_fresh_token_torch,
            "paged_decode": pa.paged_decode_attention_torch,
            "paged_prefill": pa.paged_prefill_attention_torch}[kernel]


def _store_error(fn, twin, kw: dict) -> float:
    """Max abs difference over the whole pool (values, and scales of an
    int8 pool) between the kernel's store and the twin's store on CPU
    copies of the same inputs."""
    ref = {n: t.cpu() if torch.is_tensor(t) else t for n, t in kw.items()}
    fn(**kw)
    twin(**ref)
    return max((kw[n].cpu().float() - ref[n].float()).abs().max().item()
               for n in kw if n.endswith(("pages", "scales")))


def phase_paged_kernels(prompt_lens) -> dict:
    """Each paged kernel against its twin at every form; returns per-kernel
    lists of form records."""
    device = torch.device("cuda")
    records = {"paged_store": [], "paged_decode": [], "paged_prefill": []}
    for kernel, name, fn, kw in paged_forms(device, prompt_lens):
        twin = _twin(kernel)
        if kernel == "paged_store":
            err = _store_error(fn, twin, kw)
            ok = err <= PAGED_TOL["store"]
            msg = f"max|pool-twin| {err:.3e} (tol {PAGED_TOL['store']})"
        else:
            out, lse = fn(**kw)
            torch.cuda.synchronize()
            up = {n: (t.float() if n in ("q", "k_new", "v_new")
                      and t is not None else t) for n, t in kw.items()}
            want, want_lse = twin(**up)
            err = (out.float() - want).abs().max().item()
            rel = err / want.abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and \
                rel <= PAGED_TOL["out_rel"] and err_lse <= PAGED_TOL["lse"]
            msg = (f"max|out-twin| {err:.3e} = {rel:.3e} of max|twin| (tol "
                   f"{PAGED_TOL['out_rel']:.3e}) max|lse-twin| {err_lse:.3e}"
                   f" (tol {PAGED_TOL['lse']})")
            err = max(err, err_lse)
        ms = time_ms(lambda: fn(**kw), iters=3)
        plain_ms = time_ms(lambda: twin(**kw), iters=3)
        log(f"kernel {name}: {msg} kernel {ms:.3f} ms, twin {plain_ms:.3f} ms")
        if not ok:
            raise AssertionError(f"{kernel} disagrees with twin at {name}")
        records[kernel].append(dict(form=name, max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms))
        del kw
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------- phase 3


class CodePointTokenizer:
    """Stand-in for the InternLM2 tokenizer, which cannot be downloaded:
    each character is its code point + 3 (0-2 are unk/bos/eos, code points
    from 92000 map to unk), and the chat and image special tokens, matched
    first, take InternLM2's ids. Every id stays below the 92553 vocab."""

    SPECIAL = {"<|im_end|>": 92542, "<|im_start|>": 92543, "<img>": 92544,
               "</img>": 92545, "<IMG_CONTEXT>": 92546}
    LIMIT = 92000

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.SPECIAL[token]

    def __call__(self, text: str) -> dict:
        import re

        ids = [1]  # bos
        pattern = "|".join(re.escape(s) for s in self.SPECIAL)
        for part in re.split(f"({pattern})", text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
            else:
                ids.extend(ord(c) + 3 if ord(c) + 3 < self.LIMIT else 0
                           for c in part)
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self.SPECIAL.items()}
        out = []
        for i in ids:
            if 3 <= i < self.LIMIT:
                out.append(chr(i - 3))
            elif i in inv and not skip_special_tokens:
                out.append(inv[i])
        return "".join(out)


def _tiles(n: int, seed: int) -> np.ndarray:
    """n normalized 448x448 tiles in the (T, 3, 448, 448) float32 layout."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3, 448, 448), dtype=np.float32)


def _request_pixels() -> list:
    return [_tiles(n, seed) if n else None
            for seed, (n, _) in enumerate(REQUESTS)]


def prompt_lengths(chat) -> list:
    """Token counts of the served prompts, as chat() builds them."""
    return [len(chat.encode_chat(q, [n] if n else [])[0])
            for n, q in REQUESTS]


def time_request(chat, cfg, ids, pos, pixels, gc, **kw):
    """TTFT and decode rate of one request through generate, after a warm
    call: (TTFT s, total s, decode tok/s, generated tokens)."""
    from v2pe_tpu_torch.infer.generate import generate

    args = (torch.as_tensor(ids[None]), torch.tensor([len(ids)]),
            torch.as_tensor(pos[None]), torch.as_tensor(pixels),
            torch.ones(len(pixels), dtype=torch.int32),
            chat.img_context_token_id)
    first = dataclasses.replace(gc, max_new_tokens=1)
    generate(chat.model, cfg, first, *args, **kw)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(chat.model, cfg, first, *args, **kw)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens, _, lens = generate(chat.model, cfg, gc, *args, **kw)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    n = int(lens[0])
    rate = (n - 1) / (total - ttft) if n > 1 else float("nan")
    return ttft, total, rate, tokens[0, :n].cpu().numpy()


def phase_serve(chat, cfg) -> dict:
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    pixels = _request_pixels()
    n_layers = cfg.vision.num_hidden_layers + cfg.llm.num_hidden_layers
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    answers = chat.batch_chat(pixels, [q for _, q in REQUESTS], gc)
    counts = read_launches()
    wall = time.perf_counter() - t0
    launches = counts["flash_fwd"]
    log(f"serve: 3 requests in {wall:.3f}s, flash kernel launches "
        f"{launches}; answers {[len(a) for a in answers]} chars")
    assert len(answers) == 3 and all(isinstance(a, str) for a in answers)
    # each image request: every ViT and LLM layer; the text request: the
    # LLM layers of its prefill (decode steps use the einsum path)
    want = 2 * n_layers + cfg.llm.num_hidden_layers
    if launches < want:
        raise AssertionError(f"{launches} kernel launches, expected {want}")

    # TTFT and decode rate of the first (8-tile) request, timed apart
    tiles, question = REQUESTS[0]
    ids, pos, _ = chat.encode_chat(question, [tiles])
    full = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_ids=tuple(
        chat.conv_template.stop_token_ids))
    ttft, total, rate, tokens = time_request(chat, cfg, ids, pos, pixels[0],
                                             full)
    log(f"serve: prompt {len(ids)} tokens ({tiles} tiles): TTFT "
        f"{ttft * 1e3:.1f} ms, {len(tokens)} tokens in {total * 1e3:.1f} ms,"
        f" decode {rate:.1f} tok/s")
    return dict(counts=counts, ids=ids, pos=pos, pixels=pixels[0],
                gc=full, tokens=tokens)


# ---------------------------------------------------------------- phase 4


def phase_stream(chat, cfg, served: dict, cache_mode: str = "dense") -> None:
    """stream_generate's tokens against generate's (``served["tokens"]``)
    for the same request and cache mode."""
    from v2pe_tpu_torch.infer.streaming import stream_generate

    stop = set(served["gc"].eos_token_ids)
    chunks = list(stream_generate(
        chat.model, cfg, served["gc"], served["ids"][None],
        served["pos"][None], served["pixels"],
        np.ones(len(served["pixels"]), np.int32),
        chat.img_context_token_id, chunk=8, cache_mode=cache_mode))
    streamed = [int(t) for c in chunks for t in c]
    generated = [int(t) for t in served["tokens"]]
    while generated and generated[-1] in stop:
        generated.pop()
    while streamed and streamed[-1] in stop:
        streamed.pop()
    log(f"stream ({cache_mode}): {len(chunks)} chunks, {len(streamed)} "
        f"tokens, equal to generate: {streamed == generated}")
    if streamed != generated:
        raise AssertionError(f"stream {streamed} != generate {generated}")


# ---------------------------------------------------------------- phase 5


def packed_batch(chat, S: int, device):
    """One packed row: an 8-tile chat prompt, then two text segments, with
    per-segment V2PE ids and global token positions."""
    ids1, pos1, _ = chat.encode_chat(
        "<image>\nWhat is in this picture? Answer in detail.", [8])
    rng = np.random.default_rng(3)
    n2 = (S - len(ids1)) // 2
    n3 = S - len(ids1) - n2
    ids = np.concatenate([ids1, rng.integers(3, 20000, n2),
                          rng.integers(3, 20000, n3)])
    pos = np.concatenate([pos1, np.arange(n2), np.arange(n3)])
    seg = np.repeat([1, 2, 3], [len(ids1), n2, n3])
    t = lambda a, dt: torch.as_tensor(a[None], dtype=dt, device=device)
    return dict(input_ids=t(ids, torch.int64),
                rope_pos_ids=t(pos, torch.float32),
                segment_ids=t(seg, torch.int32),
                token_positions=t(np.arange(S), torch.int32))


def phase_packed(chat, cfg, batch: dict) -> None:
    from v2pe_tpu_torch.models.internvl_chat import forward

    S = batch["input_ids"].shape[1]
    pix = torch.as_tensor(_tiles(8, 4), device="cuda")
    flags = torch.ones(8, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        run = lambda: forward(chat.model, cfg, pixel_values=pix,
                              image_flags=flags,
                              img_context_token_id=chat.img_context_token_id,
                              **batch).logits
        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ok = logits.shape == (1, S, cfg.llm.vocab_size) and \
        bool(torch.isfinite(logits).all())
    log(f"packed: {S} tokens, 8 tiles, 3 segments in {dt * 1e3:.1f} ms "
        f"= {S / dt:.0f} tok/s; logits {tuple(logits.shape)} finite {ok}")
    if not ok:
        raise AssertionError("packed forward logits malformed")


def _small_paged(model, cfg, dev: str):
    """The small model's paged path on one device: greedy tokens of a
    ragged paged generate, and the fp32 logits of two chunked prefills (the
    second over the first's pages), a 6-token step (separate-fresh fold)
    and four decode steps (store, then attend)."""
    from v2pe_tpu_torch.infer import paged_kv as pk
    from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.models import internlm2

    m = model.to(dev)
    rng = np.random.default_rng(8)
    ids = rng.integers(3, 990, (2, 40))
    ids[1, 29:] = 0
    pos = np.broadcast_to(np.arange(40, dtype=np.float32), (2, 40)).copy()
    tokens, _, lens = generate(
        m, cfg, GenerationConfig(max_new_tokens=8), torch.as_tensor(ids),
        torch.tensor([40, 29]), torch.as_tensor(pos),
        torch.zeros(1, 3, 112, 112), torch.zeros(1, dtype=torch.int32), 999,
        cache_mode="paged", page_size=16)
    seq = torch.as_tensor(rng.integers(3, 990, (1, 74)), device=dev)
    lc = cfg.llm
    cache = pk.PagedKVCache.zeros(lc, 1, 12, 16, 10, dtype=torch.float32,
                                  device=dev)
    logits = []
    with torch.inference_mode():
        for a, b in ((0, 40), (40, 64)):
            out, cache = chunked_prefill(m.llm, lc, cache,
                                         input_ids=seq[:, a:b])
            logits.append(out)
        for a, b in [(64, 70)] + [(t, t + 1) for t in range(70, 74)]:
            n = torch.tensor([b - a], dtype=torch.int32, device=dev)
            cache = pk.allocate_rows(cache, n)
            out, cache = internlm2.llm_forward(m.llm, lc,
                                               input_ids=seq[:, a:b],
                                               paged_cache=cache)
            cache = pk.advance_lengths(cache, n)
            logits.append(out)
    return tokens[:, :int(lens.max())].cpu(), torch.cat(
        [x[0].cpu() for x in logits])


def phase_small_reference() -> None:
    """The whole packed forward at a small width in fp32: on the card
    (through the flash kernel) against the CPU (through the twin); then
    the same model's paged path, whose tokens must be identical and whose
    logits must agree to 1e-4 (the paged kernels against their twins)."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.models.internvl_chat import forward
    from v2pe_tpu_torch.models.params import init_vlm_params

    cfg = config.VLMConfig(
        vision=config.VisionConfig(hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   image_size=112, patch_size=14),
        llm=config.LLMConfig(vocab_size=1000, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2)
    model = init_vlm_params(cfg, torch.Generator().manual_seed(5))
    S, nit = 300, cfg.num_image_token
    ids = np.random.default_rng(6).integers(3, 990, S)
    ids[10:10 + 2 * nit] = 999
    seg = np.repeat([1, 2, 0], [150, 130, 20])
    pos = np.concatenate([np.arange(150), np.arange(130), np.ones(20)])
    pos[11:10 + 2 * nit] = 10 + 0.25 * np.arange(1, 2 * nit)
    pix = _tiles(2, 7)[:, :, :112, :112]
    outs = []
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        t = lambda a, dt: torch.as_tensor(np.asarray(a)[None], dtype=dt,
                                          device=dev)
        with torch.inference_mode():
            outs.append(forward(
                m, cfg, input_ids=t(ids, torch.int64),
                pixel_values=torch.as_tensor(pix, device=dev),
                image_flags=torch.ones(2, dtype=torch.int32, device=dev),
                rope_pos_ids=t(pos, torch.float32), img_context_token_id=999,
                segment_ids=t(seg, torch.int32),
                token_positions=t(np.arange(S), torch.int32)
            ).logits[0, :280].cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    log(f"reference: small packed forward fp32, card vs CPU max|dlogit| "
        f"{err:.3e} (tol 1e-4, |logit| <= {outs[0].abs().max().item():.3f})")
    if err > 1e-4:
        raise AssertionError("card and CPU forwards disagree")
    (tok_cpu, lg_cpu), (tok_gpu, lg_gpu) = (_small_paged(model, cfg, dev)
                                            for dev in ("cpu", "cuda"))
    err = (lg_cpu - lg_gpu).abs().max().item()
    same = torch.equal(tok_cpu, tok_gpu)
    log(f"reference: small paged path fp32 (page 16, hd 64), card vs CPU "
        f"tokens {tok_gpu.shape[1]} x 2 identical {same}, max|dlogit| "
        f"{err:.3e} over {lg_cpu.shape[0]} positions (tol 1e-4)")
    if not same or err > 1e-4:
        raise AssertionError("card and CPU paged paths disagree")


# ----------------------------------------------------- phase 6: paged serve

LOGIT_TOL = 0.1  # bf16 paths apart: max |dlogit| / max |logit|
LOGIT_TOL_FP32 = 1e-4  # fp32: summation order through 24 layers
LONG_HISTORY, LONG_TURN = 32000, 2000  # characters = code-point tokens
DECODE_STEPS = 4  # teacher-forced decode steps held paged against dense


def first_logits(chat, cfg, ids, pos, pixels, tokens, cache_mode: str,
                 kv_dtype=None, steps: int = DECODE_STEPS):
    """fp32 logits of the prompt's last position and of ``steps`` decode
    steps fed ``tokens`` (teacher forcing), through the dense cache or the
    paged one (page 128): (1 + steps, V)."""
    from v2pe_tpu_torch.infer import paged_kv as pk
    from v2pe_tpu_torch.infer.generate import (paged_prefill_cache,
                                               prompt_embeds)
    from v2pe_tpu_torch.models import internlm2
    from v2pe_tpu_torch.models.internlm2 import KVCache

    llm = chat.model.llm
    dev = llm.tok_embeddings.weight.device
    S = len(ids)
    paged = cache_mode == "paged"
    with torch.inference_mode():
        x = prompt_embeds(chat.model, cfg,
                          torch.as_tensor(ids[None], device=dev),
                          torch.as_tensor(pixels),
                          torch.ones(len(pixels), dtype=torch.int32),
                          chat.img_context_token_id)
        if paged:
            cache = paged_prefill_cache(cfg.llm, 1, S + steps, 128, kv_dtype,
                                        x.dtype, dev)
            cache = pk.allocate_rows(cache, torch.tensor([S], device=dev))
        else:
            cache = KVCache.zeros(cfg.llm, 1, S + steps, dtype=x.dtype,
                                  device=dev)

        def run(**kw):
            key = "paged_cache" if paged else "kv_cache"
            return internlm2.llm_forward(llm, cfg.llm, **kw,
                                         **{key: cache})

        hidden, cache = run(inputs_embeds=x, return_hidden=True,
                            rope_pos_ids=torch.as_tensor(pos[None],
                                                         device=dev))
        out = [internlm2.head_logits(hidden[:, -1], llm.output.weight)]
        if paged:
            cache = dataclasses.replace(cache, lengths=torch.tensor(
                [S], dtype=torch.int32, device=dev))
        for t in range(steps):
            if paged:
                cache = pk.allocate_rows(cache,
                                         torch.ones_like(cache.lengths))
            lg, cache = run(
                input_ids=torch.tensor([[int(tokens[t])]], device=dev),
                rope_pos_ids=torch.tensor([[float(pos[-1]) + 1 + t]],
                                          device=dev))
            if paged:
                cache = pk.advance_lengths(cache, 1)
            out.append(lg[:, 0])
    return torch.cat(out).float()


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def phase_paged_serve(model, cfg, tok, served: dict) -> dict:
    """The three requests through a paged ChatModel (page 128): launches,
    TTFT and decode rate of the 8-tile request, stream against generate,
    paged logits against dense, and the 8-tile request again on an int8
    pool."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    chat = ChatModel(model, cfg, tok, cache_mode="paged")
    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    pixels = _request_pixels()
    reset_launches()
    t0 = time.perf_counter()
    answers = chat.batch_chat(pixels, [q for _, q in REQUESTS], gc)
    counts = read_launches()
    log(f"paged serve: 3 requests in {time.perf_counter() - t0:.3f}s, "
        f"launches {counts}; answers {[len(a) for a in answers]} chars")
    require(counts, ("flash_fwd", "paged_store", "paged_decode"),
            "paged serve")

    tiles, _ = REQUESTS[0]
    ids, pos, pix = served["ids"], served["pos"], served["pixels"]
    for kv in ("int8", None):  # bf16 last: its tokens meet the stream's
        ttft, total, rate, tokens = time_request(
            chat, cfg, ids, pos, pix, served["gc"], cache_mode="paged",
            kv_dtype=kv)
        log(f"paged serve ({kv or 'bf16'} pool): prompt {len(ids)} tokens "
            f"({tiles} tiles): TTFT {ttft * 1e3:.1f} ms, {len(tokens)} "
            f"tokens in {total * 1e3:.1f} ms, decode {rate:.1f} tok/s")
    phase_stream(chat, cfg, dict(served, tokens=tokens), cache_mode="paged")

    dense = first_logits(chat, cfg, ids, pos, pix, served["tokens"], "dense")
    paged = first_logits(chat, cfg, ids, pos, pix, served["tokens"], "paged")
    int8 = first_logits(chat, cfg, ids, pos, pix, served["tokens"], "paged",
                        kv_dtype="int8")
    d_paged, d_int8 = _rel(paged, dense), _rel(int8, dense)
    log(f"paged vs dense logits (prefill + {DECODE_STEPS} decode steps, "
        f"bf16): max|dlogit|/max|logit| {d_paged:.3e} (tol {LOGIT_TOL}); "
        f"int8 pool vs dense {d_int8:.3e}; argmax equal "
        f"{torch.equal(paged.argmax(-1), dense.argmax(-1))}")
    # the same in fp32 (bf16 -> fp32 -> bf16 is exact): what is left is
    # summation order, so the bf16 distance above is rounding
    model.float()
    dense, paged = (first_logits(chat, cfg, ids, pos, pix, served["tokens"],
                                 mode) for mode in ("dense", "paged"))
    model.to(torch.bfloat16)
    d32 = _rel(paged, dense)
    log(f"paged vs dense logits, the same in fp32: max|dlogit|/max|logit| "
        f"{d32:.3e} (tol {LOGIT_TOL_FP32}); argmax equal "
        f"{torch.equal(paged.argmax(-1), dense.argmax(-1))}")
    if not (d_paged <= LOGIT_TOL and d32 <= LOGIT_TOL_FP32):
        raise AssertionError("paged logits disagree with dense")
    return counts


# -------------------------------------------------------- phase 7: session


def phase_session(model, cfg, tok) -> dict:
    """ChatSession at full width, page 512: an 8-tile image turn, then two
    text turns that prefill only their suffix over the pool (the paged
    prefill kernel); turn 2's first-token logits against a full re-prefill
    of its prompt (what chat(history=...) runs). Then one 2k-token turn
    over a 32k-token history, timed."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.infer.session import ChatSession

    chat = ChatModel(model, cfg, tok, cache_mode="paged")
    sess = ChatSession(chat, max_len=8192, page_size=512)
    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    pix = _tiles(8, 9)
    turns = [(pix, "Describe the image in detail."),
             (None, "What colours stand out?"),
             (None, "Summarise that in one sentence.")]
    total = {}
    for i, (pv, q) in enumerate(turns):
        history = list(sess.history)
        reset_launches()
        t0 = time.perf_counter()
        reply = sess.send(pv, q, gc)
        counts = read_launches()
        log(f"session turn {i + 1}: {sess.consumed} tokens in the pool, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {len(reply)} chars; "
            f"launches {counts}")
        if i:
            require(counts, ("paged_prefill", "paged_decode", "paged_store"),
                    f"session turn {i + 1}")
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        if i == 1:
            ids, pos, _ = chat.encode_chat(q, [8], history)
            ref = first_logits(chat, cfg, ids, pos, pix, [], "dense",
                               steps=0)
            d = _rel(sess.last_logits.float(), ref[:1])
            log(f"session turn 2 first-token logits vs full re-prefill of "
                f"{len(ids)} tokens: max|dlogit|/max|logit| {d:.3e} "
                f"(tol {LOGIT_TOL})")
            if not d <= LOGIT_TOL:
                raise AssertionError("session disagrees with re-prefill")

    rng = np.random.default_rng(12)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    long_sess = ChatSession(chat, max_len=LONG_HISTORY + 2 * LONG_TURN,
                            page_size=512)
    one = GenerationConfig(max_new_tokens=1)
    t0 = time.perf_counter()
    long_sess.send(None, "".join(rng.choice(letters, LONG_HISTORY)), one)
    torch.cuda.synchronize()
    fill = time.perf_counter() - t0
    history = long_sess.consumed
    reset_launches()
    t0 = time.perf_counter()
    long_sess.send(None, "".join(rng.choice(letters, LONG_TURN)), one)
    counts = read_launches()
    turn = time.perf_counter() - t0
    log(f"session: {long_sess.consumed - history}-token turn over a "
        f"{history}-token history: {turn * 1e3:.1f} ms to the first token "
        f"(history prefill {fill * 1e3:.1f} ms); launches {counts}")
    require(counts, ("paged_prefill",), "2k-over-32k turn")
    # decode rate at that context: a turn of 33 new tokens less a turn of
    # one, steps counted from the decode kernel's launches
    t0 = time.perf_counter()
    long_sess.send(None, "Go on.", one)
    t_one = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    long_sess.send(None, "Go on again.", GenerationConfig(max_new_tokens=33))
    counts = read_launches()
    t_many = time.perf_counter() - t0
    steps = counts["paged_decode"] // cfg.llm.num_hidden_layers
    log(f"session: decode over a {long_sess.consumed}-token context: "
        f"{steps} steps in {(t_many - t_one) * 1e3:.1f} ms = "
        f"{steps / (t_many - t_one):.1f} tok/s (a {t_many * 1e3:.1f} ms turn "
        f"less a 1-token turn of {t_one * 1e3:.1f} ms)")
    return total


# --------------------------------------------------------- phase 8: worker


def phase_worker(model, cfg, tok) -> dict:
    """The port's ModelWorker over the paged ChatModel on 127.0.0.1: its
    status route, a text request through /worker_generate_stream and the
    same through /v1/chat/completions with SSE; both texts must equal
    ChatModel.chat's greedy text for the prompt."""
    import threading
    import urllib.request

    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.serve.worker import ModelWorker

    chat = ChatModel(model, cfg, tok, cache_mode="paged")
    question, n_new = "Write a haiku about the sea.", 24
    want = chat.chat(None, question, GenerationConfig(max_new_tokens=n_new))
    server = ModelWorker(chat, model_name="internvl2-2b").make_server(
        host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(
            url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.read()

    try:
        status = json.loads(post("/worker_get_status", {}))
        reset_launches()
        raw = post("/worker_generate_stream", {
            "prompt": chat.build_query(question, []),
            "max_new_tokens": n_new, "temperature": 0.0})
        counts = read_launches()
        chunks = [json.loads(c) for c in raw.split(b"\0") if c]
        native = chunks[-1]["text"] if chunks else ""
        raw = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": question}],
            "max_tokens": n_new, "stream": True}).decode()
        events = [ln[len("data: "):] for ln in raw.split("\n\n")
                  if ln.startswith("data: ")]
        sse = "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                      for e in events[:-1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    ok = (status["model_names"] == ["internvl2-2b"]
          and all(c["error_code"] == 0 for c in chunks)
          and events[-1] == "[DONE]" and native.strip() == want
          and sse.strip() == want)
    log(f"worker: status {status}; generate stream {len(chunks)} chunks, "
        f"SSE {len(events) - 1} events; texts equal to chat(): "
        f"{native.strip() == want}/{sse.strip() == want} ({len(want)} chars)"
        f"; launches {counts}")
    if not ok:
        raise AssertionError(f"worker texts {native!r} / {sse!r} != chat "
                             f"{want!r}")
    require(counts, ("paged_store", "paged_decode"), "worker")
    return counts


# ------------------------------------------------ phase 2c: flash backward


BWD_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}  # max|kernel -
# twin| / max|twin| of each of dq, dk, dv; the twin computes in fp32
BWD_KERNELS = ("flash_bwd_dkv", "flash_bwd_dq")


def bwd_forms(device, packed: dict):
    """(name, args, kwargs) of the backward at the training path's forms:
    the LLM's packed 8192 tokens (three segments and a padded tail, GQA
    16/8 x 128, causal, explicit positions, q rotated from the V2PE ids),
    the ViT's 8 tiles (16 x 64, bidirectional), and a ragged fp32 form with
    q and k rotated, a padded tail and a row that attends nothing."""
    g = torch.Generator(device="cpu").manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(device=device, dtype=dtype)

    def arange(B, S):
        return torch.arange(S, dtype=torch.int32,
                            device=device).expand(B, S).contiguous()

    seg = packed["segment_ids"].to(device).clone()
    S = seg.shape[1]
    seg[:, S - 200:] = 0
    forms = [(f"llm_packed_{S}_3seg_pad_qrope_bf16", (
        randn(1, S, 16, 128), randn(1, S, 8, 128), randn(1, S, 8, 128),
        seg, seg, arange(1, S), arange(1, S)),
        dict(causal=True, scale=128 ** -0.5,
             rope_q=packed["rope_pos_ids"].to(device), rope_theta=1e6))]
    ones = torch.ones(8, 1025, dtype=torch.int32, device=device)
    forms.append(("vit_tiles_8x1025_bf16", (
        randn(8, 1025, 16, 64), randn(8, 1025, 16, 64),
        randn(8, 1025, 16, 64), ones, ones, arange(8, 1025),
        arange(8, 1025)), dict(causal=False, scale=64 ** -0.5)))
    S = 150
    seg = torch.zeros(2, S, dtype=torch.int32, device=device)
    seg[0, :60], seg[0, 60:110] = 1, 2  # row 1: all padding
    ids = torch.cat([torch.arange(20.0), 19 + 0.25 * torch.arange(1, 41),
                     29 + torch.arange(1, 91.0)]).to(device).expand(2, S)
    f32 = torch.float32
    forms.append((f"ragged_{S}_empty_row_qkrope_fp32", (
        randn(2, S, 16, 128, dtype=f32), randn(2, S, 8, 128, dtype=f32),
        randn(2, S, 8, 128, dtype=f32), seg, seg, arange(2, S),
        arange(2, S)), dict(causal=True, scale=128 ** -0.5,
                            rope_q=ids.contiguous(), rope_k=ids.contiguous(),
                            rope_theta=1e6)))
    return forms


def device_ms_by_kernel(fn, names) -> dict:
    """Device time of one call of ``fn`` per kernel whose name contains
    each of ``names`` (torch.profiler's kernel events), in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return {n: sum(e.self_device_time_total for e in ev if n in e.key) / 1e3
            for n in names}


def phase_bwd_kernels(packed: dict, device: str = "cuda") -> dict:
    """dkv and dq against the twin at every backward form; out and lse come
    from the forward kernel. Returns per-kernel lists of form records: each
    kernel's device time, and the twin's time for the whole backward."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    records = {n: [] for n in BWD_KERNELS}
    for name, args, kw in bwd_forms(torch.device(device), packed):
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        do = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)
                         ).to(out)
        full = (*args, out, lse, do)
        got = flash_bwd.flash_attention_bwd(*full, **kw)
        torch.cuda.synchronize()
        up = [a.float() if a.is_floating_point() else a for a in full]
        want = flash_bwd.flash_attention_bwd_torch(*up, **kw)
        rels = [((a.float() - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, want)]
        errs = [(a.float() - b).abs().max().item() for a, b in zip(got, want)]
        tol = BWD_TOL[args[0].dtype]
        ms = time_ms(lambda: flash_bwd.flash_attention_bwd(*full, **kw),
                     iters=3)
        split = device_ms_by_kernel(
            lambda: flash_bwd.flash_attention_bwd(*full, **kw),
            [n + "_kernel" for n in BWD_KERNELS])
        plain_ms = time_ms(
            lambda: flash_bwd.flash_attention_bwd_torch(*full, **kw), iters=3)
        log(f"kernel bwd {name}: max|d-twin|/max|twin| dq {rels[0]:.3e} "
            f"dk {rels[1]:.3e} dv {rels[2]:.3e} (tol {tol:.3e}); dkv "
            f"{split['flash_bwd_dkv_kernel']:.3f} ms + dq "
            f"{split['flash_bwd_dq_kernel']:.3f} ms on the device, wrapper "
            f"{ms:.3f} ms, twin {plain_ms:.3f} ms")
        ok = all(torch.isfinite(t).all() for t in got) and max(rels) <= tol
        if not ok:
            raise AssertionError(f"flash backward disagrees with twin at "
                                 f"{name}")
        for n in BWD_KERNELS:
            records[n].append(dict(form=name, max_abs_err=max(errs),
                                   max_rel_err=max(rels),
                                   ms=split[n + "_kernel"],
                                   plain_ms=plain_ms))
        del got, want, full, up
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ phase 9: train


TRAIN_TOKENS, TRAIN_TILES, TRAIN_STEPS = 8192, 8, 4


def synthetic_sample(rng, n_tokens: int, tiles: int, nit: int, size: int,
                     ids=(92544, 92545, 92546), vocab_hi: int = 20000,
                     stride: int = 64) -> dict:
    """One training sample as a dataset yields it: 16 text tokens, an
    image span of ``tiles`` tiles, more text; V2PE ids at ``stride``;
    labels on the text only; random normalized pixels."""
    from v2pe_tpu_torch import positional

    start, end, ctx = ids
    img = [start] + [ctx] * (tiles * nit) + [end]
    body = np.concatenate([rng.integers(3, vocab_hi, 16), img,
                           rng.integers(3, vocab_hi,
                                        n_tokens - 16 - len(img))])
    pos = positional.build_v2pe_pos_ids(body, np.ones_like(body), [tiles],
                                        img_start_id=start, img_end_id=end,
                                        num_image_token=nit,
                                        version="v2pe_fix", stride=stride)
    labels = np.where(np.isin(body, img), -100, body)
    return dict(input_ids=body, pos_ids=np.asarray(pos, np.float32),
                labels=labels,
                pixel_values=rng.standard_normal(
                    (tiles, 3, size, size), dtype=np.float32),
                image_flags=np.ones(tiles, np.int64))


def small_train_batch(cfg, device) -> dict:
    """Two samples (150 and 130 tokens, one 112-pixel tile each) packed
    into a 300-token row with a padded tail, as the trainer collates."""
    from v2pe_tpu_torch import packing

    rng = np.random.default_rng(13)
    nit = cfg.num_image_token
    rows = [[synthetic_sample(rng, n, 1, nit, 112, ids=(997, 998, 999),
                              vocab_hi=990, stride=2) for n in (150, 130)]]
    batch = packing.collate_rows(rows, max_tokens=300, max_tiles=2,
                                 img_context_token_id=999,
                                 num_image_token=nit)
    batch.pop("statistics")
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _max_rel(a: dict, b: dict) -> float:
    """Largest max|a - b| / max|b| over the tensors of two state dicts."""
    return max(((a[n].float() - b[n].float()).abs().max()
                / b[n].float().abs().max().clamp_min(1e-30)).item()
               for n in b)


def phase_small_train_reference(devices=("cpu", "cuda")) -> None:
    """One make_train_step step (int8 Adam, lr 1e-5, no warmup) of a
    2-layer fp32 model on the card (the kernels) against the CPU (the
    twins): loss, grad_norm and every gradient leaf within 1e-4 of its
    range, every updated parameter within 1e-4 of its range plus 1% of one
    step (Adam's first step g / (|g| + eps) has slope 1/eps where g ~ eps,
    which turns summation-order noise into up to ~1e-3 of a step on
    zero-initialized biases, whose range is one step). Then on the card:
    save a checkpoint after step 1, restore it into a fresh model and take
    step 2; it must equal step 2 of the uninterrupted run."""
    import copy
    import tempfile

    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.core import checkpoint as ckpt
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer
    from v2pe_tpu_torch.train.train_step import loss_fn, make_train_step

    cfg = config.VLMConfig(
        vision=config.VisionConfig(hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   image_size=112, patch_size=14),
        llm=config.LLMConfig(vocab_size=1000, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2)
    tc = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=10,
                     use_8bit_optimizer=True)
    base = init_vlm_params(cfg, torch.Generator().manual_seed(21))

    def start(dev):
        model = copy.deepcopy(base).to(dev).train()
        opt = build_optimizer(tc, model, cfg)
        return model, opt, opt.init(), make_train_step(
            cfg, opt, img_context_token_id=999, remat="full")

    res = {}
    for dev in devices:
        batch = small_train_batch(cfg, dev)
        model = copy.deepcopy(base).to(dev)
        loss_fn(model, cfg, batch, 999, remat="full").backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        model, _, state, step = start(dev)
        loss, gnorm = step(model, state, batch)
        res[dev] = (loss.item(), gnorm.item(), grads, {
            n: p.detach().cpu() for n, p in model.named_parameters()})
    (l_c, g_c, d_c, p_c), (l_g, g_g, d_g, p_g) = (res[d] for d in devices)
    d_loss, d_gn = abs(l_g - l_c) / abs(l_c), abs(g_g - g_c) / abs(g_c)
    d_grad = _max_rel(d_g, d_c)
    d_par = max(((p_g[n] - p_c[n]).abs().max() / (
        1e-4 * p_c[n].abs().max() + 1e-2 * tc.learning_rate)).item()
        for n in p_c)  # <= 1 passes
    log(f"reference: small train step fp32 (int8 Adam), card vs CPU: loss "
        f"{l_g:.6f} vs {l_c:.6f} (rel {d_loss:.2e}), grad_norm {g_g:.6f} vs "
        f"{g_c:.6f} (rel {d_gn:.2e}), gradients max|d|/range {d_grad:.2e} "
        f"(tol 1e-4); params max|d| at {d_par:.2f} of the tolerance")
    if max(d_loss, d_gn, d_grad) > 1e-4 or d_par > 1.0:
        raise AssertionError("card and CPU train steps disagree")

    batch = small_train_batch(cfg, devices[1])
    model, _, state, step = start(devices[1])
    step(model, state, batch)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save_checkpoint(tmp, 1, model, state, data_state={"step": 1},
                             cfg=cfg)
        step(model, state, batch)
        fresh, _, template, step2 = start(devices[1])
        fresh, restored, at, ds = ckpt.restore_checkpoint(
            ckpt.latest_checkpoint(tmp), fresh, template)
        step2(fresh, restored, batch)
    d = _max_rel(dict(fresh.named_parameters()),
                 dict(model.named_parameters()))
    log(f"reference: checkpoint at step {at} (data state {ds}), resumed "
        f"step 2 vs uninterrupted: params max|d|/range {d:.2e} (tol 1e-6)")
    if at != 1 or d > 1e-6:
        raise AssertionError("resumed run disagrees with uninterrupted run")


def train_packer(cfg, seed: int = 0):
    """A PackedSampleIterator over 16 in-memory samples of 1024 tokens with
    one 448-pixel tile each: every packed row is 8 samples, 8192 tokens
    and 8 tiles."""
    from v2pe_tpu_torch import packing

    rng = np.random.default_rng(seed)
    per = TRAIN_TOKENS // TRAIN_TILES
    samples = [synthetic_sample(rng, per, 1, cfg.num_image_token, 448)
               for _ in range(2 * TRAIN_TILES)]
    return packing.PackedSampleIterator({"synthetic": samples},
                                        max_tokens=TRAIN_TOKENS,
                                        max_tiles_per_row=TRAIN_TILES,
                                        seed=seed,
                                        img_context_token_id=92546)


def train_config():
    from v2pe_tpu_torch.train.optimizer import TrainConfig

    # the bench recipe: lr 1e-5, warmup 1, int8 Adam
    return TrainConfig(learning_rate=1e-5, warmup_steps=1,
                       total_steps=TRAIN_STEPS, use_8bit_optimizer=True)


def phase_train(model, cfg) -> dict:
    """Four steps of InternVL2-2B through trainer.train on 8192 packed
    tokens and 8 tiles (remat 'full', int8 Adam, lr 1e-5, warmup 1), then
    one asynchronous checkpoint: per-step loss, grad_norm, time and rate,
    the median over steps 2-4, peak memory, the save's time and size, and
    the launches of each step."""
    import os
    import tempfile

    from v2pe_tpu_torch.core import checkpoint as ckpt
    from v2pe_tpu_torch.train.trainer import RunConfig, train

    steps, marks = [], {}

    def hook(step, metrics):
        counts = read_launches()
        prev = marks.get("counts", {k: 0 for k in counts})
        steps.append(dict(metrics, launches={
            k: counts[k] - prev[k] for k in counts}))
        marks["counts"] = counts
        marks["t"] = time.perf_counter()

    model.train()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(output_dir=tmp, max_steps=TRAIN_STEPS,
                        save_steps=TRAIN_STEPS, log_steps=1,
                        max_packed_tokens=TRAIN_TOKENS,
                        max_tiles=TRAIN_TILES)
        reset_launches()
        train(cfg, model, train_packer(cfg), run, train_config(),
              img_context_token_id=92546, remat="full", resume=False,
              metrics_hook=hook)
        counts = read_launches()
        save_s = time.perf_counter() - marks["t"]
        path = ckpt.latest_checkpoint(tmp)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.eval()
    for i, m in enumerate(steps):
        ms = TRAIN_TOKENS / m["tokens_per_sec"] * 1e3
        log(f"train step {i + 1}: loss {m['loss']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} {ms:.1f} ms {m['tokens_per_sec']:.0f} "
            f"tok/s; launches {m['launches']}")
    rates = sorted(m["tokens_per_sec"] for m in steps[1:])
    med = rates[len(rates) // 2]
    log(f"train: {TRAIN_STEPS} steps of {TRAIN_TOKENS} tokens x "
        f"{TRAIN_TILES} tiles (remat full, int8 Adam): median of steps 2-"
        f"{TRAIN_STEPS} {med:.0f} tok/s = {TRAIN_TOKENS / med * 1e3:.1f} ms "
        f"a step; peak {peak:.2f} GiB allocated; async save + commit "
        f"{save_s:.2f}s, {size / 2 ** 30:.2f} GiB at step {path[-8:]}")
    check_train_steps(cfg, steps, TRAIN_STEPS, "train")
    return counts


def check_train_steps(cfg, steps: list, n: int, where: str) -> None:
    """n steps, each with a finite loss and grad norm, launching the flash
    forward twice a layer (remat 'full') and each backward kernel once."""
    n_layers = cfg.vision.num_hidden_layers + cfg.llm.num_hidden_layers
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dkv": n_layers,
            "flash_bwd_dq": n_layers}
    ok = len(steps) == n and all(
        np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        and all(m["launches"][k] == v for k, v in want.items())
        for m in steps)
    if not ok:
        raise AssertionError(f"{where} phase: expected finite losses and "
                             f"{want} launches a step")


BENCH_STEPS = 3


def bench_recipe(model, cfg):
    """What bench.py's training bench builds (``bench.py:299-334``), from
    the port: make_train_step (remat 'full', int8 Adam, lr 1e-5, warmup 1)
    and make_synthetic_batch's one row of 8192 tokens with 8 tiles at
    V2PE stride 64. Returns (step, opt_state, batch)."""
    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID, make_synthetic_batch
    from v2pe_tpu_torch.train.train_step import make_train_step

    opt = build_optimizer(train_config(), model, cfg)
    step = make_train_step(cfg, opt, img_context_token_id=IMG_CONTEXT_ID,
                           remat="full")
    batch = make_synthetic_batch(cfg, 1, TRAIN_TOKENS,
                                 tiles_per_row=TRAIN_TILES, stride=64)
    dev = next(model.parameters()).device
    return step, opt.init(), {k: torch.as_tensor(v).to(dev)
                              for k, v in batch.items()}


def phase_bench_recipe(model, cfg) -> dict:
    """Three steps of the bench recipe (make_train_step called directly,
    the first step bench.py's compile step): per-step loss, grad_norm,
    time and launches, and the median rate of steps 2-3."""
    step, state, batch = bench_recipe(model, cfg)
    steps = []
    model.train()
    reset_launches()
    for i in range(BENCH_STEPS):
        before = read_launches()
        t0 = time.perf_counter()
        loss, gnorm = step(model, state, batch)
        loss, gnorm = loss.item(), gnorm.item()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        steps.append(dict(loss=loss, grad_norm=gnorm, ms=ms, launches={
            k: after[k] - before[k] for k in after}))
        log(f"bench recipe step {i + 1}: loss {loss:.4f} grad_norm "
            f"{gnorm:.4f} {ms:.1f} ms {TRAIN_TOKENS / ms * 1e3:.0f} tok/s; "
            f"launches {steps[-1]['launches']}")
    counts = read_launches()
    model.eval()
    ms = sorted(m["ms"] for m in steps[1:])[len(steps[1:]) // 2]
    log(f"bench recipe: make_train_step on make_synthetic_batch, "
        f"{TRAIN_TOKENS} tokens x {TRAIN_TILES} tiles in one segment "
        f"(remat full, int8 Adam): median of steps 2-{BENCH_STEPS} "
        f"{ms:.1f} ms = {TRAIN_TOKENS / ms * 1e3:.0f} tok/s")
    check_train_steps(cfg, steps, BENCH_STEPS, "bench recipe")
    return counts


def profile_train(model, cfg) -> None:
    """``--profile-train``: one full-width step of the bench recipe (a
    warm step first) under torch.profiler: wall, device time, busy share,
    kernels launched and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    step, state, batch = bench_recipe(model, cfg)
    model.train()
    step(model, state, batch)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = step(model, state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in ev) / 1e3
    log(f"profile train step, {TRAIN_TOKENS} tokens x {TRAIN_TILES} tiles, "
        f"loss {loss.item():.4f}: wall {wall:.1f} ms, device {dev:.1f} ms "
        f"({dev / wall:.0%} busy), {sum(e.count for e in ev)} kernels")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<6}"
            f" {e.key[:80]}")


# ---------------------------------------------------------------- profile


def profile_generate(chat, cfg) -> None:
    """``--profile``: the 8-tile request through generate (dense, paged
    bf16, paged int8 pool; the first token alone, then 32 tokens) under
    torch.profiler: wall, device time (the kernel events' sum), busy share,
    kernels launched, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate

    tiles, question = REQUESTS[0]
    ids, pos, _ = chat.encode_chat(question, [tiles])
    args = (torch.as_tensor(ids[None]), torch.tensor([len(ids)]),
            torch.as_tensor(pos[None]), torch.as_tensor(_tiles(tiles, 0)),
            torch.ones(tiles, dtype=torch.int32), chat.img_context_token_id)
    stop = tuple(chat.conv_template.stop_token_ids)
    for mode, kv in (("dense", None), ("paged", None), ("paged", "int8")):
        for n in (1, MAX_NEW):
            gc = GenerationConfig(max_new_tokens=n, eos_token_ids=stop)
            run = lambda: generate(chat.model, cfg, gc, *args,
                                   cache_mode=mode, kv_dtype=kv)
            run()  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _, _, lens = run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # kernel events only: the aten ops carry their kernels' time too
            ev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            dev = sum(e.self_device_time_total for e in ev) / 1e3
            log(f"profile {mode} {kv or 'bf16'}, {int(lens[0])} tokens: wall "
                f"{wall:.1f} ms, device {dev:.1f} ms ({dev / wall:.0%} busy),"
                f" {sum(e.count for e in ev)} kernels")
            for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<6}"
                    f" {e.key[:80]}")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile the 8-tile request's generate (dense, "
                    "paged, int8 pool) with torch.profiler; no result line")
    ap.add_argument("--profile-train", action="store_true",
                    help="only profile one full-width train step with "
                    "torch.profiler; no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()

    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.models.params import init_vlm_params

    cfg = config.internvl2_2b()
    t0 = time.perf_counter()
    model = init_vlm_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: InternVL2-2B, {n_params / 1e9:.3f}B params bf16, random "
        f"init in {time.perf_counter() - t0:.2f}s")
    tok = CodePointTokenizer()
    chat = ChatModel(model, cfg, tok)
    if args.profile or args.profile_train:
        if args.profile:
            profile_generate(chat, cfg)
        else:
            profile_train(model, cfg)
        log(card_line())
        return 0
    batch = packed_batch(chat, PACKED_LEN, "cuda")
    prompt_lens = prompt_lengths(chat)
    forms = {"flash_fwd": phase_kernels(prompt_lens, batch),
             **phase_bwd_kernels(batch), **phase_paged_kernels(prompt_lens)}
    phase_small_reference()
    phase_small_train_reference()
    served = phase_serve(chat, cfg)
    phase_stream(chat, cfg, served)
    phase_packed(chat, cfg, batch)
    # the paged paths, each driven with the launch counts zeroed before it
    paths = [served["counts"], phase_paged_serve(model, cfg, tok, served),
             phase_session(model, cfg, tok), phase_worker(model, cfg, tok)]
    del chat
    # last: the training paths update the weights
    paths += [phase_train(model, cfg), phase_bench_recipe(model, cfg)]
    launches = {k: sum(c[k] for c in paths) for k in forms}

    kernels = [dict(
        name=name, route="cuda", source=KERNEL_SOURCES[name],
        replaces=KERNEL_REPLACES[name], launches=launches[name],
        max_abs_err=max(f["max_abs_err"] for f in recs),
        ms=sum(f["ms"] for f in recs),
        plain_ms=sum(f["plain_ms"] for f in recs), forms=recs)
        for name, recs in forms.items()]
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
