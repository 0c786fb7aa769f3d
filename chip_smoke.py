"""Drive the PyTorch port's serving, training and sequence-parallel paths
once on one CUDA card.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --profile        # only a torch.profiler breakdown
                                           # of the 8-tile request's generate
                                           # and of one engine decode block
    python3 chip_smoke.py --profile-train  # only a torch.profiler breakdown
                                           # of one full-width train step
    python3 chip_smoke.py --probe          # only a quick check and times of
                                           # the flash tiles (backward and
                                           # forward)

Phases, each of which fails the run (nonzero exit, no result line):
  1. device: the card's name and power limit, torch/CUDA versions, and the
     build of the CUDA kernels from this checkout's sources;
  2. kernels: every kernel against its plain PyTorch twin at every form
     the serving paths give it, with errors and times: the flash forward;
     the paged store, decode and prefill kernels in bf16, int8 and int4
     (the served rows, one row over 32k tokens at ChatModel's page 128, the
     session's store and decode over a 34k context at page 512, a
     2048-token chunk over a 32k history; in bf16 and int4 also the
     engine's decode of 8 rows of 8.2k tokens with 1 and with 5 fresh
     tokens; decode and prefill twice into NaN-filled outputs with equal
     bits, beside scaled_dot_product_attention on the K/V gathered
     beforehand), then a seeded random sweep of 32 forms each of the paged
     decode and prefill (page sizes 8-512, head dims, pools, fresh-token
     modes, dead entries, empty rows, split counts);
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
     Phase 11, quantized serve: the three requests through
     ChatModel(weights_dtype="int8") and "int4" on the dense cache and
     int8 weights over the paged cache with an int8 pool: every LLM product
     and the vocab head through the quantized kernels (5 x 24 stacked
     launches and 1 head launch a forward, none of the other width), TTFT
     and decode rate, stream equal to generate, first-token logits against
     the bf16 model's. It runs before the training phases.
     Phase 12, the engine (serve/engine.py), also before the training
     phases: the 32k-history session once more with int4 weights over an
     int4 pool (w4kv4); the serving-throughput recipe of the JAX package's
     bench through InferenceEngine (8 requests of 8192 random tokens, 256
     new each, 8 rows, page 512, chunks of 2048, blocks of 64 steps): total
     and generated tok/s, an admission's time, ms a decode step at 8 rows,
     launches and synchronising reads a block (one: the harvest), the
     pool's bytes; 4 chat requests (8 tiles, 1 tile, text, the 8-tile one
     again) through EngineChat with the prefix cache on, over a bf16, an
     int8 and an int4 pool and with speculative_k = 4; one request over HTTP
     through ModelWorker(engine=...); one text request with 3 beams.
Phase 2 holds the flash forward's bf16 forms against its twin on the same
bf16 inputs (the twin rounds where the tensor cores do) and on fp32 copies,
then sweeps 40 seeded random forms of it (head dims, GQA ratios, ragged
lengths, padding rows, straddling segments, permuted positions, rotary,
causal or not, bf16 and fp32) against the twin. It also holds the four
quantized-product kernels against their plain
versions (the head at M = 1 and 3, each layer product at M = 3, wqkv and
w2 at the 2167-row prefill; bf16 and fp32 x) and the two flash-backward kernels against their twin at
the training path's forms (the 8192-token packed LLM, 8 ViT tiles, a
ragged fp32 form; bf16 both on fp32 copies and on the same bf16 inputs with
the kernels' rounding points), then at 24 seeded random forms (head dims,
GQA ratios, zigzag rectangles, ragged tails, padding rows, bf16 and fp32).
A small fp32 model on the card against the same model
on the CPU (the kernels against their twins: a packed forward, then the
paged path with identical tokens, then one train step and a checkpoint
resume; then 2-layer int8 and int4 models; then a 2-row engine that must
queue, reuse rows and hit a shared prefix, plain and speculative and over
an int4 pool; then beam search) runs after phase 2. Phases 3 and
6-11 each zero the kernels' launch
counts before they start and read them after, and fail if a kernel of
their path was not launched. The kernel table prints as one JSON line:
per kernel the launches of the driven paths and, at its main form, the
error, the kernel's and the plain version's time, the bound (the larger of
bytes moved once at 3.35 TB/s and operations at the peak of their type)
and the time of one PyTorch library call where one computes the same
function (timed here, used nowhere in the port); the other forms' numbers
are on their ``kernel ...`` lines.
Sequence parallelism (``parallel/``: every shard of the ``seq`` axis on this
one card): phase 2 also holds the fused ring forward against its plain
version at six forms (main: 4 ranks, zigzag, causal, 32,768 tokens, bf16;
the ring trainer's 8192 tokens) and against the flash forward on the
unsharded sequence, the scan ring against the fused one with their launches
and reads of the card, the ring's backward against the plain and the dense
flash backward, and the three flash kernels against their plain twins at
the rectangles the ring cuts at both full-width shapes; a small fp32 model under
``seq_shards=4`` runs on the card against the CPU (forward in both ring
modes, one train step). Phase 13, the long eval: InternVL2-2B answers one
32,768-token, 32-tile needle prompt through
``evalkit.mm_niah_long.teacher_forced_eval``, unsharded and under
``ShardingContext(seq_shards=4)`` with the scan and the fused ring (the fused
kernel once a decoder layer; the fused ring's logits and answer tokens held
against the scan ring's, and both against the unsharded run's).
Phase 14, after the other training phases: two steps of ``make_train_step``
under ``MeshConfig(seq=4)`` with the fused ring on 8192 tokens + 8 tiles,
held against an unsharded step on the same weights.
Phase 15, checkpoint and eval, after the engine phases (before the long
eval and the training phases, which change the weights): the model exported
through ``models/export.py`` as a bf16 HF safetensors directory in a
temporary directory and loaded back onto the card by the port's own reader
(every tensor and the 8-tile request's first logits equal bit for bit;
seconds and GB/s of each); then ``evalkit.cli.main`` on that directory, the
MM-NIAH route over 8 made-up text-only needle items of 1k-16k tokens with 32
new tokens, three times: dense (#1), ``--engine-rows 4`` (#1, #6, #5 with
its riding store) and ``--weights-dtype int8`` (#1, #7, #8), each with its
items/s, response tok/s, score and launches an item. Where the engine's
response differs from the dense one, the dense path's logits at the first
differing token, teacher-forced on the common prefix, must put the engine's
token within LOGIT_TOL of the best: bf16 chunked prefill and paged decode
are other sums than the dense route's, so near ties may go either way.
LoRA, compress-seq, seq-cls and utils: phase 2 also holds #1-#3 at the
compress-seq decoder's two forms (the interaction over 4 x 100 summary
tokens, bf16 and fp32; the within-chunk attention over the packed 8192
tokens, segment sample x 4 + chunk + 1), and a small fp32 LoRA step, a
compress-seq step with each fuse method and the seq-cls head run on the
card against the CPU. Phase 16, after the long eval: InternVL2-2B's LoRA
adapters (ranks 16 / 8) train 3 steps through trainer.train (launches as
phase 9; the base bit for bit unchanged; an adapters-only asynchronous
checkpoint); one more LoRA step inside utils.profile_trace (the trace
names the flash kernels), StepTimer, nan_guard and assert_finite on an
injected inf; ChatModel(lora=fresh adapters) answers the three requests
as the base model did, ChatModel(lora=the trained adapters) and
export_torch_state_dict(lora=) equal the merged model train returned, bit
for bit. Phases 17-19, after phase 14: three compress-seq train steps with
each fuse method on the bench recipe's batch (4 chunks; launches 96 /
72 / 72 a step), one 8192-token fuse-only forward (24 launches) and the
seq-cls head on 4 right-padded rows of up to 2048 tokens (24 launches).
Training across processes: phase 2 also holds #1-#3 at the shapes one rank
of a mesh gives them, outputs allocated full of NaN: under tensor = 2 the
ViT's 8 x 64 heads, the LLM's 8/4 x 128 heads on the packed 8192 tokens
and compress-seq's two attentions at 8/4 heads, under seq = 2 the
rectangles the scan ring cuts from the zigzag shards of that row. Phase
20, between the trainer's steps and the bench recipe's: the mesh's
training path as a world of 1 over NCCL (the process group through
``parallel/bootstrap.py`` on a file store, a copy of the model placed by
``parallel/mesh.py:shard_model`` under FSDP2, three steps of
``make_train_step(mesh=MeshConfig())`` with int8 Adam on the bench
recipe's batch, its state gathered to one device's layout), then LoRA
placed by ``place_lora`` and compress-seq placed, each beside its unplaced
run; the bench recipe then takes its three steps from the same weights in
one process: losses and grad norms within RING_TRAIN_TOL, the int8 states
by ``compare_int8``. Then two processes on the card over gloo at fsdp 2
(``phase_two_ranks``). Phase 15 also runs ``tools.inference_test`` on the
exported checkpoint. Then the card line, then the last line {"ok": true,
"device": {...}}.

Imports neither jax nor the JAX package, nor PIL/transformers/tokenizers
at module level: the pixels come from numpy and the text from a
code-point tokenizer (``tool_inference_test`` writes its image with PIL).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL = {  # max abs error of a flash forward kernel against its plain twin
    # bf16: on the same bf16 inputs the twin rounds where the tensor cores
    # do, so what is left is the order of the fp32 sums (lse) and, on out,
    # P's bf16 rounding against the running max instead of the row's final
    # max plus the bf16 output: a bf16 step or two at |out| < 4. Against the
    # twin on fp32 copies of the inputs the same limits hold where nothing
    # is rotated (bf16 operands times a scale applied to the fp32 scores are
    # the fp32 scores exactly); with rotary see rotary_limits
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
    "qdot": "v2pe_tpu_torch/csrc/quantized_matmul.cu",
    "qdot_stacked": "v2pe_tpu_torch/csrc/quantized_matmul.cu",
    "q4dot": "v2pe_tpu_torch/csrc/quantized_matmul.cu",
    "q4dot_stacked": "v2pe_tpu_torch/csrc/quantized_matmul.cu",
    "ring_fused_fwd": "v2pe_tpu_torch/csrc/ring_fused_fwd.cu",
}
KERNEL_REPLACES = {  # the Pallas kernel bodies
    "flash_fwd": "v2pe_tpu/ops/flash_pallas.py:68",
    "flash_bwd_dkv": "v2pe_tpu/ops/flash_pallas_bwd.py:72",
    "flash_bwd_dq": "v2pe_tpu/ops/flash_pallas_bwd.py:137",
    "paged_store": "v2pe_tpu/ops/paged_attention.py:58",
    "paged_decode": "v2pe_tpu/ops/paged_attention.py:187",
    "paged_prefill": "v2pe_tpu/ops/paged_attention.py:433",
    "qdot": "v2pe_tpu/ops/quantized_matmul.py:245",
    "qdot_stacked": "v2pe_tpu/ops/quantized_matmul.py:297",
    "q4dot": "v2pe_tpu/ops/quantized_matmul.py:405",
    "q4dot_stacked": "v2pe_tpu/ops/quantized_matmul.py:437",
    "ring_fused_fwd": "v2pe_tpu/parallel/ring_fused.py:63",
}
# the card's published peaks (H100 SXM, dense): device memory, and the
# rate of the operands' type (fp32 runs outside the tensor cores)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def time_ms(fn, iters: int = 5, behind_spin: bool = True) -> float:
    """Time of one call of ``fn`` between two CUDA events around ``iters``
    calls, after a warm call. ``behind_spin``: the card first spins for
    about 20 ms while the host enqueues the calls, which then run back to
    back: the device's time, with the host out of the way (a short kernel's
    wrapper costs the host more than the kernel costs the card). Without
    it, calls run as the host issues them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if behind_spin:
        torch.cuda._sleep(40_000_000)  # cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roof(nbytes: float, flops: float, dtype=torch.bfloat16) -> dict:
    """The least time the card could take: every input byte read and every
    output byte written once at the memory's peak rate, or the operations at
    the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def reset_launches() -> None:
    """Zero every kernel's launch count (just before a path is driven)."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd
    from v2pe_tpu_torch.ops import paged_attention as pa
    from v2pe_tpu_torch.ops import quantized_matmul as qm
    from v2pe_tpu_torch.parallel import ring_fused

    flash_fwd.LAUNCHES = 0
    ring_fused.LAUNCHES = 0
    for counts in (pa.LAUNCHES, flash_bwd.LAUNCHES, qm.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    """Every kernel's launch count (just after a path was driven)."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd
    from v2pe_tpu_torch.ops import paged_attention as pa
    from v2pe_tpu_torch.ops import quantized_matmul as qm
    from v2pe_tpu_torch.parallel import ring_fused

    torch.cuda.synchronize()
    return {"flash_fwd": flash_fwd.LAUNCHES, **flash_bwd.LAUNCHES,
            **pa.LAUNCHES, **qm.LAUNCHES,
            "ring_fused_fwd": ring_fused.LAUNCHES}


def require(counts: dict, names, where: str) -> None:
    missing = [n for n in names if counts[n] == 0]
    if missing:
        raise AssertionError(f"{where}: no launch of {missing} ({counts})")


def require_riding_store(counts: dict, where: str) -> None:
    """A path of paged decode steps: no store launch of its own, and the
    fresh tokens' store riding in every paged decode launch."""
    if not (counts["paged_store"] == 0 and counts["paged_decode"] > 0
            and counts["paged_decode_store"] == counts["paged_decode"]):
        raise AssertionError(f"{where}: expected no paged_store launch and "
                             f"one riding store a paged_decode launch "
                             f"({counts})")


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
    return forms + compress_forms(randn, packed, device)


COMPRESS_CHUNKS = 4  # --chunk_num of the compress-seq forms and phases


def compress_forms(randn, packed: dict, device):
    """(name, args, kwargs) of the compress-seq decoder's two attentions
    (``models/compress_seq.py``), its rotary applied outside the kernel:
    the interaction over the 4 chunks' 4 x 100 summary tokens (one
    segment, causal; 400 rows, a ragged tail for 64-row tiles) in bf16
    and on fp32 copies, and the within-chunk attention over the packed
    8192 tokens (three samples and a padded tail) cut into 4 chunks:
    segment ``sample * 4 + chunk + 1``, 0 kept for the padding."""
    n_sum = COMPRESS_CHUNKS * 100
    ar = torch.arange(n_sum, dtype=torch.int32, device=device)[None]
    ones = torch.ones(1, n_sum, dtype=torch.int32, device=device)
    q, k, v = randn(1, n_sum, 16, 128), randn(1, n_sum, 8, 128), \
        randn(1, n_sum, 8, 128)
    kw = dict(causal=True, scale=128 ** -0.5)
    forms = [(f"interaction_{n_sum}_bf16", (q, k, v, ones, ones, ar, ar), kw),
             (f"interaction_{n_sum}_fp32", (q.float(), k.float(), v.float(),
                                            ones, ones, ar, ar), kw)]
    seg = packed["segment_ids"].to(device).clone()
    S = seg.shape[1]
    seg[:, S - 200:] = 0
    chunk = torch.arange(S, device=device)[None] // (S // COMPRESS_CHUNKS)
    seg = torch.where(seg == 0, 0, seg * COMPRESS_CHUNKS + chunk + 1).to(
        torch.int32)
    ar = torch.arange(S, dtype=torch.int32, device=device)[None]
    forms.append((f"compress_chunks_{S}_4x3seg_pad_bf16", (
        randn(1, S, 16, 128), randn(1, S, 8, 128), randn(1, S, 8, 128),
        seg, seg, ar, ar), kw))
    return forms


def attended_pairs(seg_q, seg_k, pos_q, pos_k, causal: bool) -> int:
    """The (query, key) pairs of one head that the masks let through (equal
    nonzero segments, and under ``causal`` key position <= query
    position), summed over the rows: what this input's attention has to
    compute."""
    total = 0
    for b in range(seg_q.shape[0]):
        for q0 in range(0, seg_q.shape[1], 2048):
            sq = seg_q[b, q0:q0 + 2048, None]
            ok = (sq == seg_k[b][None]) & (sq != 0)
            if causal:
                ok &= pos_k[b][None] <= pos_q[b, q0:q0 + 2048, None]
            total += int(ok.sum())
    return total


def useful_tflops(q, pairs: int, ms: float) -> float:
    """The two products' operations on the attended pairs, over a time."""
    return 4.0 * q.shape[2] * q.shape[3] * pairs / (ms * 1e-3) / 1e12


def attention_roof(q, k, v, pairs: int, products: int, *moved) -> dict:
    """Bound of an attention kernel that runs ``products`` matrix products
    (2 * D operations each) per attended pair and query head, and reads or
    writes q, k, v and ``moved`` once."""
    Hq, D = q.shape[2], q.shape[3]
    return roof(nbytes(q, k, v, *moved), 2.0 * D * products * pairs * Hq,
                q.dtype)


def sdpa(q, k, v, causal: bool, scale: float):
    """One library call for the forms it can express: no padding, one
    segment, keys in order (with ``causal``, query i sees keys <= i)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, scale=scale,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def library_ms(fn, iters: int = 5):
    """Time of a library call kept for the record; None (and a line that
    says why) when this installation refuses the call."""
    try:
        return time_ms(fn, iters=iters)
    except RuntimeError as e:  # the record only: nothing on the path calls it
        log(f"    library call refused: {e}")
        return None


def rotary_limits(q, k, v, kw) -> dict:
    """Limits of a bf16 kernel against its twin on fp32 copies of the
    inputs when q (and k) are rotated in the kernel. The kernel rounds the
    rotated q once to bf16 (|dq_i| <= 2^-9 |q_i|), and the rotated k too
    with rope_k, so a score moves by at most
    d = scale 2^-9 (1 + [rope_k]) max|q| max|k| (Cauchy-Schwarz over the
    rows' norms, which the rotation keeps). Then |dlse| <= d, and each
    softmax weight moves by a factor within exp(+-2d), so
    |dout| <= (exp(2d) - 1) max|v|. Each on top of TOL's bf16 limit."""
    norms = lambda t: t.float().norm(dim=-1).max().item()
    d = kw["scale"] * 2.0 ** -9 * (1 + (kw.get("rope_k") is not None)) \
        * norms(q) * norms(k)
    tol = TOL[torch.bfloat16]
    return {"out": tol["out"] + (np.exp(2 * d) - 1)
            * v.float().abs().max().item(), "lse": tol["lse"] + d}


def check_flash(name, args, kw, out, lse) -> tuple:
    """The forward kernel's (out, lse) against its plain twin: in fp32 on
    the same inputs; in bf16 on the same bf16 inputs (both at TOL) and on
    fp32 copies of them (TOL, or rotary_limits where q is rotated). Raises
    on a disagreement; returns the errors as text and the largest."""
    from v2pe_tpu_torch.ops import flash_fwd

    def errs(ref):
        return ((out.float() - ref[0].float()).abs().max().item(),
                (lse - ref[1]).abs().max().item())

    dtype = args[0].dtype
    same = errs(flash_fwd.flash_attention_fwd_torch(*args, **kw))
    checks = [("twin", same, TOL[dtype])]
    if dtype == torch.bfloat16:
        up = [a.float() if a.is_floating_point() and a.ndim == 4 else a
              for a in args]
        lim = rotary_limits(*args[:3], kw) if kw.get("rope_theta") \
            else TOL[dtype]
        checks.append(("fp32 twin", errs(
            flash_fwd.flash_attention_fwd_torch(*up, **kw)), lim))
    text = " ".join(
        f"max|out-{what}| {e[0]:.3e} (tol {lim['out']:.3g}) max|lse-{what}| "
        f"{e[1]:.3e} (tol {lim['lse']:.3g})" for what, e, lim in checks)
    if not (torch.isfinite(out).all() and all(
            e[0] <= lim["out"] and e[1] <= lim["lse"]
            for _, e, lim in checks)):
        raise AssertionError(f"kernel disagrees with twin at {name}: {text}")
    return text, max(same)


def phase_kernels(prompt_lens, packed: dict) -> list:
    """Kernel against twin at every form; returns per-form records. The
    main form is the 8-tile request's dense prefill."""
    from v2pe_tpu_torch.ops import flash_fwd

    device = torch.device("cuda")
    records = []
    for name, args, kw in kernel_forms(device, prompt_lens, packed):
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        torch.cuda.synchronize()
        text, err = check_flash(name, args, kw, out, lse)
        ms = time_ms(lambda: flash_fwd.flash_attention_fwd(*args, **kw))
        plain_ms = time_ms(
            lambda: flash_fwd.flash_attention_fwd_torch(*args, **kw))
        q, k, v, seg_q, seg_k, pos_q, pos_k = args
        pairs = attended_pairs(seg_q, seg_k, pos_q, pos_k, kw["causal"])
        bound = attention_roof(q, k, v, pairs, 2, out, lse)
        lib = None
        if name.startswith(("vit_tiles", "dense_prefill", "interaction")):
            lib = library_ms(lambda: sdpa(q, k, v, kw["causal"], kw["scale"]))
        log(f"kernel {name}: {text} kernel {ms:.3f} ms "
            f"({useful_tflops(q, pairs, ms):.1f} TFLOP/s useful), twin "
            f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']}, library "
            f"(scaled_dot_product_attention) "
            f"{'none' if lib is None else f'{lib:.3f} ms'}")
        records.append(dict(form=name, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, **bound, library_ms=lib,
                            main=name == f"dense_prefill_{prompt_lens[0]}x"
                            f"{prompt_lens[0] + MAX_NEW}_bf16"))
    return records


SWEEP_FORMS = 40  # seeded random forms of the flash forward


def sweep_form(rng, device):
    """(name, args, kwargs) of one random form of the flash forward: head
    dim 64 or 128, GQA ratio 1, 2 or 4, lengths no tile divides, segments
    cut at random (so they straddle tiles) with padding runs and, at times,
    an all-padding batch row, positions in order, shifted (a query block at
    the end of its keys) or permuted, causal or not, sometimes q (and k)
    rotated in the kernel, bf16 or fp32."""
    D, G = int(rng.choice([64, 128])), int(rng.choice([1, 2, 4]))
    Hkv, B = int(rng.integers(1, 3)), int(rng.integers(1, 3))
    Sq = int(rng.integers(1, 400))
    Sk = Sq if rng.random() < 0.5 else int(rng.integers(1, 500))
    causal, dtype = bool(rng.integers(2)), \
        [torch.bfloat16, torch.float32][int(rng.integers(2))]

    def segments(S):
        seg = np.zeros((B, S), np.int32)
        for b in range(B):
            cuts = np.sort(rng.integers(0, S + 1, int(rng.integers(0, 4))))
            seg[b] = np.searchsorted(cuts, np.arange(S), side="right") + 1
            for _ in range(int(rng.integers(0, 3))):  # padding runs
                a = int(rng.integers(0, S))
                seg[b, a:a + int(rng.integers(1, 80))] = 0
        if B > 1 and rng.random() < 0.3:
            seg[int(rng.integers(B))] = 0
        return seg

    seg_q = segments(Sq)
    seg_k = seg_q.copy() if Sk == Sq and rng.random() < 0.7 else segments(Sk)
    pos_k = np.broadcast_to(np.arange(Sk), (B, Sk)).copy()
    how = ["arange", "shifted", "permuted"][int(rng.integers(3))]
    if how == "permuted":
        pos_q = np.stack([rng.permutation(Sq) for _ in range(B)])
        pos_k = np.stack([rng.permutation(Sk) for _ in range(B)])
    else:
        pos_q = np.broadcast_to(np.arange(Sq) + (Sk - Sq if how == "shifted"
                                                 else 0), (B, Sq)).copy()
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, dtype)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
        device)
    args = (x(B, Sq, Hkv * G, D), x(B, Sk, Hkv, D), x(B, Sk, Hkv, D),
            i32(seg_q), i32(seg_k), i32(pos_q), i32(pos_k))
    kw = dict(causal=causal, scale=D ** -0.5)
    rope = ["none", "q", "qk"][int(rng.integers(3))]
    if rope != "none":
        ids = lambda p: torch.from_numpy((p * 0.75).astype(np.float32)).to(
            device)
        kw.update(rope_q=ids(pos_q), rope_theta=1e6,
                  rope_k=ids(pos_k) if rope == "qk" else None)
    name = (f"B{B}_{Sq}x{Sk}_{Hkv * G}/{Hkv}x{D}_"
            f"{'causal' if causal else 'bidir'}_{how}_rope-{rope}_"
            f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}")
    return name, args, kw


def phase_flash_sweep(device: str = "cuda") -> list:
    """The flash forward kernel against its twin at SWEEP_FORMS seeded
    random forms (sweep_form), each held as phase_kernels holds its forms;
    one line with the count and the largest errors."""
    from v2pe_tpu_torch.ops import flash_fwd

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    records, worst = [], (0.0, "")
    for _ in range(SWEEP_FORMS):
        name, args, kw = sweep_form(rng, device)
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        torch.cuda.synchronize()
        _, err = check_flash(f"sweep {name}", args, kw, out, lse)
        worst = max(worst, (err, name))
        records.append(dict(form=f"sweep_{name}", max_abs_err=err,
                            main=False))
    log(f"kernel sweep flash_fwd: {SWEEP_FORMS} seeded random forms within "
        f"their limits; largest error against the twin on the same inputs "
        f"{worst[0]:.3e} at {worst[1]}; {time.perf_counter() - t0:.1f} s")
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
NEG_INF_LSE = -1e30  # the lse of a query that attends nothing
SESSION_CONTEXT = 34165  # tokens in the pool where the session decodes
ENGINE_CONTEXT = 8192     # tokens of an engine row's prompt


def _pool(L, NP, ps, kind: str, g, device):
    """A random pool of one kind: bf16 values; int8 codes with scales; or
    int4 codes as packed bytes (two nibbles each, half the int8 pool's
    bytes) with scales 18 times larger (amax / 7 against amax / 127)."""
    shape = (L, LLM_HKV, NP, ps, LLM_HD)
    if kind == "bf16":
        k, v = (torch.randn(shape, generator=g, device=device,
                            dtype=torch.bfloat16) for _ in range(2))
        return dict(k_pages=k, v_pages=v)
    if kind == "int4":
        shape = shape[:4] + (LLM_HD // 2,)
    k, v = (torch.randint(-127, 128, shape, generator=g, device=device,
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:3] + (1, ps), generator=g, device=device)
              * 0.025 + 0.005 for _ in range(2))
    if kind == "int4":
        ks, vs = ks * 18.0, vs * 18.0
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


POOL_SHARDS = 4  # the sequence shards of the sharded serving forms


def _shard_rows(lengths, ps, extra, n, device):
    """Page tables of rows holding ``lengths`` (+ extra) tokens over a pool
    of ``n`` sequence shards, placed by ``paged_kv.allocate_rows`` (table
    slot s on shard s % n) in a pool of as many pages as the rows take, a
    shard's share plus its null page; (table, global pages)."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.infer import paged_kv as pk

    need = [-(-(m + extra) // ps) for m in lengths]
    NP = n * (max(sum(-(-(k - d) // n) for k in need) for d in range(n)) + 1)
    tiny = config.LLMConfig(hidden_size=2, num_hidden_layers=1,
                            num_attention_heads=1, num_key_value_heads=1)
    cache = pk.PagedKVCache.zeros(tiny, len(lengths), NP, ps, max(need),
                                  dtype=torch.float32, n_shards=n,
                                  device=device)
    cache = pk.allocate_rows(cache, torch.tensor(lengths, device=device)
                             + extra)
    return cache.page_table, NP


def shard_forms(tag: str, q, g, device):
    """The sharded serving path's forms of the paged kernels (one card
    holding POOL_SHARDS shards of the pool): the engine's 8 rows of 8.2k to
    11.8k tokens, whose fresh pages fall on every shard, and a retired row
    (every entry dead) at page 512, each
    shard's launch over its compacted table (``shard_views``): the store
    standalone and riding in the T = 1 decode with ``fresh_pages`` (-1 for
    the rows whose fresh page another shard holds), the T = 5 verify step
    with the fresh tokens folded on shard 0 and left out on another, and a
    2048-token chunk over row 0's 8k history on a compacted table with dead
    entries. The stores write a 2-layer pool of the same pages (a store's
    check copies the pool to the CPU); the reads run on the 24 layers."""
    from v2pe_tpu_torch.ops import paged_attention as pa

    n, forms = POOL_SHARDS, []
    rows = [ENGINE_CONTEXT + 517 * b for b in range(8)] + [0]
    table, NP = _shard_rows(rows, 512, 8, n, device)
    table[-1] = -1                                   # the retired row
    lens = torch.tensor(rows, dtype=torch.int32, device=device)
    views = pa.shard_views(table, lens, n, NP, 512, fresh=True)
    B = len(rows)
    small = _pool(2, NP, 512, tag, g, device)
    for d in (1, 2):  # each holds the fresh pages of two rows
        v = views[d]
        forms.append(("paged_store", f"store_shard{d}of{n}_engine_B{B}_"
                      f"ps512_{tag}", pa.store_fresh_token,
                      dict(k_new=q(B, 1, LLM_HKV), v_new=q(B, 1, LLM_HKV),
                           page_table=v.page_table, lengths=lens, layer=1,
                           fresh_pages=v.fresh_pages, **small)))
    v = views[1]
    forms.append(("paged_decode", f"decode_store_shard1of{n}_engine_B{B}_"
                  f"T1_ps512_{tag}", pa.paged_decode_attention,
                  dict(q=q(B, 1), k_new=q(B, 1, LLM_HKV),
                       v_new=q(B, 1, LLM_HKV), page_table=v.page_table,
                       slot_base=v.slot_base, lengths=lens, layer=1,
                       fresh_in_pages=True, return_lse=True, store=True,
                       fresh_pages=v.fresh_pages, **small)))
    pool = _pool(LLM_L, NP, 512, tag, g, device)
    for d in (0, 3):
        v = views[d]
        forms.append(("paged_decode", f"decode_shard{d}of{n}_engine_B{B}_T5"
                      f"_fold{int(d == 0)}_ps512_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(B, 5), k_new=q(B, 5, LLM_HKV),
                           v_new=q(B, 5, LLM_HKV), page_table=v.page_table,
                           slot_base=v.slot_base, lengths=lens,
                           layer=LLM_L - 1, fold_fresh=int(d == 0),
                           return_lse=True, **pool)))
    v = views[2]
    forms.append(("paged_prefill", f"prefill_shard2of{n}_2048_over_8k_"
                  f"ps512_{tag}", pa.paged_prefill_attention,
                  dict(q=q(1, 2048), page_table=v.page_table[:1],
                       slot_base=v.slot_base[:1], lengths=lens[:1],
                       layer=LLM_L - 1, **pool)))
    return forms


def paged_forms(device, prompt_lens):
    """(kernel, name, fn, kwargs) of every form the paged path launches, at
    its shapes: the store and the fresh_in_pages decode over the served
    rows (mid-decode, page 128), decode of one row over 32k tokens (page
    128, ChatModel's), the separate-fresh decode at T=4, the session's
    store and decode of one row over a 34k context at page 512 (on one
    pool: the decode reads the stored token), and a 2048-token chunk over
    a 32k history at page 512; each in bf16, int8 and int4. The decode
    step's own forms (``decode_store_*``) carry the store in the decode
    launch: store-then-attend over the served rows and the session's row,
    and the T=4 fold storing a prefix of each row (4, 2 and 0 tokens).
    Also, in each pool, the serving engine's forms: decode of 8 rows of
    about 8.2k tokens at page 512 with T = 1 (a decode block's step) and
    with T = 5 fresh tokens folded in separately (a speculative verify
    forward); and for int4 a 256-token chunk over the served rows at page
    128."""
    from v2pe_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=device).manual_seed(11)
    forms = []
    served = [n + MAX_NEW // 2 for n in prompt_lens]
    for tag in ("bf16", "int8", "int4"):

        def q(B, T, H=LLM_HQ):
            return torch.randn((B, T, H, LLM_HD), generator=g, device=device,
                               dtype=torch.bfloat16)

        table, NP = _rows(served, 128, MAX_NEW, device)
        lens = torch.tensor(served, dtype=torch.int32, device=device)
        pool = _pool(LLM_L, NP, 128, tag, g, device)
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
        # the store riding in the decode launch: store, then attend (a
        # decode step), and folding T = 4 with a prefix of each row stored
        forms.append(("paged_decode",
                      f"decode_store_fresh_in_pages_"
                      f"{'_'.join(map(str, served))}_ps128_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(3, 1), k_new=q(3, 1, LLM_HKV),
                           v_new=q(3, 1, LLM_HKV), page_table=table,
                           lengths=lens, layer=LLM_L - 1, fresh_in_pages=True,
                           return_lse=True, store=True, **pool)))
        forms.append(("paged_decode",
                      f"decode_store_separate_T4_B3_ps128_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(3, 4), k_new=q(3, 4, LLM_HKV),
                           v_new=q(3, 4, LLM_HKV), page_table=table,
                           lengths=lens, layer=LLM_L - 1, return_lse=True,
                           store=True, store_n=torch.tensor(
                               [4, 2, 0], dtype=torch.int32, device=device),
                           **pool)))
        n32 = 32767
        table, NP = _rows([n32], 128, 1, device)
        pool = _pool(LLM_L, NP, 128, tag, g, device)
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
        pool = _pool(LLM_L, NP, 512, tag, g, device)
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
        forms.append(("paged_decode", f"decode_store_{n}_B1_ps512_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(1, 1), k_new=q(1, 1, LLM_HKV),
                           v_new=q(1, 1, LLM_HKV), page_table=table,
                           lengths=lens, layer=LLM_L - 1, fresh_in_pages=True,
                           return_lse=True, store=True, **pool)))
        table, NP = _rows([32768], 512, 2048, device)
        pool = _pool(LLM_L, NP, 512, tag, g, device)
        forms.append(("paged_prefill", f"prefill_2048_over_32k_ps512_{tag}",
                      pa.paged_prefill_attention,
                      dict(q=q(1, 2048), page_table=table,
                           lengths=torch.tensor([32768], dtype=torch.int32,
                                                device=device),
                           layer=LLM_L - 1, **pool)))
        if tag == "int4":
            table, NP = _rows(served, 128, 256, device)
            forms.append(("paged_prefill",
                          f"prefill_256_over_served_rows_ps128_{tag}",
                          pa.paged_prefill_attention,
                          dict(q=q(3, 256), page_table=table,
                               lengths=torch.tensor(
                                   served, dtype=torch.int32, device=device),
                               layer=LLM_L - 1,
                               **_pool(LLM_L, NP, 128, tag, g, device))))
        rows = [ENGINE_CONTEXT + 37 * b for b in range(8)]  # ragged
        table, NP = _rows(rows, 512, 8, device)
        pool = _pool(LLM_L, NP, 512, tag, g, device)
        lens = torch.tensor(rows, dtype=torch.int32, device=device)
        forms.append(("paged_decode", f"decode_engine_B8_8k_T1_ps512_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(8, 1), k_new=None, v_new=None,
                           page_table=table, lengths=lens, layer=LLM_L - 1,
                           fresh_in_pages=True, return_lse=True, **pool)))
        forms.append(("paged_decode", f"decode_engine_B8_8k_T5_ps512_{tag}",
                      pa.paged_decode_attention,
                      dict(q=q(8, 5), k_new=q(8, 5, LLM_HKV),
                           v_new=q(8, 5, LLM_HKV), page_table=table,
                           lengths=lens, layer=LLM_L - 1, return_lse=True,
                           **pool)))
        del pool
        forms += shard_forms(tag, q, g, device)
    return forms


def _is_main_paged(name: str, tag: str) -> bool:
    """The paged kernels' main forms, in the pool type ``tag``."""
    return name in (f"store_B3_ps128_{tag}",
                    f"prefill_2048_over_32k_ps512_{tag}") or (
        name.startswith("decode_fresh_in_pages") and name.endswith(tag))


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


def paged_roof(kernel: str, kw: dict) -> dict:
    """Bound of a paged kernel at one form. The store reads the fresh k/v
    and writes one slot per row and kv head (and its scale); decode and
    prefill read every cached slot they attend to once (values, and scales
    of an int8 pool), the queries and the fresh k/v, write out and lse (and
    a riding store's slots), and run two products per (query, slot) pair
    and query head."""
    from v2pe_tpu_torch.ops import paged_attention as pa

    pool = kw["k_pages"]
    Hkv, ps, D = pool.shape[1], pool.shape[3], LLM_HD
    quant = kw.get("k_scales") is not None
    # a slot's k and v: its stored bytes (D/2 for int4) and its scales
    slot = 2 * Hkv * (pool.shape[4] * pool.element_size()
                      + (4 if quant else 0))
    fresh = nbytes(kw.get("k_new"), kw.get("v_new"))
    lengths = kw["lengths"]
    # a sequence shard's store writes only the rows whose page it holds
    fp = kw.get("fresh_pages")
    stored = lengths.numel() if fp is None else int((fp >= 0).sum())
    if kernel == "paged_store":
        return roof(fresh * stored // lengths.numel() + stored * slot
                    + nbytes(lengths, fp), 0)
    q = kw["q"]
    B, T, Hq, _ = q.shape
    # the slots this table holds below each row's end (a shard's compacted
    # table: its share), and the fresh slots among them
    sb = kw.get("slot_base")
    at = pa._slots(pa.default_slot_base(kw["page_table"], ps)
                   if sb is None else sb, ps).long()
    end = lengths.long()[:, None]
    past = int(((at >= 0) & (at < end)).sum())
    slots = past + (int(((at >= end) & (at < end + T)).sum())
                    if kw.get("fresh_in_pages") else 0)
    out = q.numel() * q.element_size() + B * Hq * T * 4  # out and lse
    if kw.get("store"):  # a riding store writes its tokens' slots
        n = kw.get("store_n")
        out += (stored * T if n is None else int(n.sum())) * slot
    # causal among the fresh tokens: T (T + 1) / 2 more pairs where they are
    # folded in separately (on shard 0 alone)
    folds = kernel == "paged_decode" and (kw.get("fresh_in_pages")
                                          or kw.get("fold_fresh", 1))
    pairs = T * past + (B * T * (T + 1) // 2 if folds else 0)
    return roof(slots * slot + fresh + nbytes(q, lengths) + out,
                4.0 * D * Hq * pairs, q.dtype)


def gathered_attention(kernel: str, kw: dict):
    """The library's yardstick for a paged form: a function that runs
    ``scaled_dot_product_attention`` on the same K/V already gathered
    contiguous (dequantized for a quantized pool, in the queries' dtype;
    the fresh tokens appended where they are folded), with the mask the
    form needs (none where every query sees every gathered key). The
    gather is done here, once, outside any timing; nothing of the port
    calls this."""
    import torch.nn.functional as F
    from v2pe_tpu_torch.ops import paged_attention as pa

    q, pool = kw["q"], kw["k_pages"]
    B, T, Hq, hd = q.shape
    ps, layer = pool.shape[3], kw["layer"]
    table, lengths = kw["page_table"], kw["lengths"]
    sb = kw.get("slot_base")
    if sb is None:
        sb = pa.default_slot_base(table, ps)
    kv = []
    for pages, scales in ((kw["k_pages"], kw.get("k_scales")),
                          (kw["v_pages"], kw.get("v_scales"))):
        x, sc = pa._gather_pages(pages, scales, table, layer, hd)
        kv.append(x if sc is None else x * sc[..., None])
    slot = pa._slots(sb, ps)                        # (B, K)
    if kernel == "paged_prefill":
        mask = ((slot >= 0) & (slot < lengths.long()[:, None]))[:, None]
    else:
        t = torch.arange(T, device=q.device)
        limit = lengths.long()[:, None] + (t[None] if kw.get("fresh_in_pages")
                                           else -1)
        mask = ((slot[:, None] >= 0) & (slot[:, None] <= limit[:, :, None])
                ).expand(B, T, -1)
        if not kw.get("fresh_in_pages") and kw.get("fold_fresh", 1):
            kv = [torch.cat([x, n.float().transpose(1, 2)], dim=2)
                  for x, n in zip(kv, (kw["k_new"], kw["v_new"]))]
            causal = (t[None] <= t[:, None]).expand(B, T, T)
            mask = torch.cat([mask, causal], dim=-1)
    if B == 1:  # keep only the keys some query sees
        keep = mask[0].any(0)
        kv, mask = [x[:, :, keep] for x in kv], mask[..., keep]
    k, v = (x.to(q.dtype).contiguous() for x in kv)
    m = None if bool(mask.all()) else mask[:, None]  # (B, 1, T, K)
    qt = q.transpose(1, 2).contiguous()
    scale = hd ** -0.5
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=m, scale=scale, enable_gqa=Hq != k.shape[1])


def paged_check(kernel: str, fn, kw: dict) -> tuple:
    """Run a decode or prefill form twice into NaN-filled outputs and hold
    it against the twin on fp32 copies of q and the fresh k/v within
    PAGED_TOL, the two runs' bits equal: (message, ok, largest error)."""
    with nan_empty():
        out, lse = fn(**kw)
        out2, lse2 = fn(**kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
    up = {n: (t.float() if n in ("q", "k_new", "v_new") and t is not None
              else t) for n, t in kw.items()}
    want, want_lse = _twin(kernel)(**up)
    err = (out.float() - want).abs().max().item()
    top = want.abs().max().item()
    rel = err / top if top > 0 else err
    err_lse = (lse - want_lse).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and same and \
        rel <= PAGED_TOL["out_rel"] and err_lse <= PAGED_TOL["lse"]
    msg = (f"max|out-twin| {err:.3e} = {rel:.3e} of max|twin| (tol "
           f"{PAGED_TOL['out_rel']:.3e}) max|lse-twin| {err_lse:.3e} (tol "
           f"{PAGED_TOL['lse']}); repeat bitwise equal {same}")
    return msg, ok, max(err, err_lse)


def paged_store_check(fn, kw: dict) -> tuple:
    """A decode form whose launch also stores (``store=True``): run twice
    from the same pool into NaN-filled outputs, with equal bits (outputs
    and pool); the pool it leaves exactly equal to the one the twin leaves
    on CPU copies of the same inputs (fp32 q and fresh k/v, which widen
    exactly), out and lse within PAGED_TOL of the twin's: (message, ok,
    largest error)."""
    names = [n for n in ("k_pages", "v_pages", "k_scales", "v_scales")
             if kw.get(n) is not None]
    ref = {n: (t.float() if n in ("q", "k_new", "v_new") else t).to(
        "cpu", copy=True) if torch.is_tensor(t) else t
        for n, t in kw.items()}
    before = {n: kw[n].clone() for n in names}
    with nan_empty():
        out, lse = fn(**kw)
        after = {n: kw[n].clone() for n in names}
        for n in names:
            kw[n].copy_(before[n])
        out2, lse2 = fn(**kw)
    torch.cuda.synchronize()
    same = bool(torch.equal(out, out2) and torch.equal(lse, lse2)) and all(
        torch.equal(kw[n], after[n]) for n in names)
    del before
    want, want_lse = _twin("paged_decode")(**ref)
    layer = kw["layer"]
    pool_equal = all(torch.equal(after[n].cpu(), ref[n]) for n in names)
    pool_err = max((after[n][layer].cpu().float() - ref[n][layer].float())
                   .abs().max().item() for n in names)
    err = (out.cpu().float() - want).abs().max().item()
    top = want.abs().max().item()
    rel = err / top if top > 0 else err
    err_lse = (lse.cpu() - want_lse).abs().max().item()
    ok = bool(torch.isfinite(out).all()) and same and pool_equal and \
        pool_err <= PAGED_TOL["store"] and rel <= PAGED_TOL["out_rel"] \
        and err_lse <= PAGED_TOL["lse"]
    msg = (f"max|pool-twin| {pool_err:.3e} (tol {PAGED_TOL['store']}), "
           f"pool equal {pool_equal}; max|out-twin| {err:.3e} = {rel:.3e} "
           f"of max|twin| (tol {PAGED_TOL['out_rel']:.3e}) max|lse-twin| "
           f"{err_lse:.3e} (tol {PAGED_TOL['lse']}); repeat bitwise equal "
           f"(out, lse, pool) {same}")
    return msg, ok, max(pool_err, err, err_lse)


def phase_paged_kernels(prompt_lens) -> dict:
    """Each paged kernel against its twin at every form; returns per-kernel
    lists of form records. Decode and prefill run twice into NaN-filled
    outputs with equal bits. No library call computes these functions over
    a page table: their yardstick is ``scaled_dot_product_attention`` on
    the same K/V gathered contiguous beforehand (``gathered_attention``).
    Main forms: the served rows' store and decode and the 2048-token chunk,
    bf16 pools; their int8 and int4 counterparts are the records' ``pool``
    forms."""
    device = torch.device("cuda")
    records = {"paged_store": [], "paged_decode": [], "paged_prefill": []}
    for kernel, name, fn, kw in paged_forms(device, prompt_lens):
        twin = _twin(kernel)
        lib_ms = None
        if kernel == "paged_store":
            err = _store_error(fn, twin, kw)
            ok = err <= PAGED_TOL["store"]
            msg = f"max|pool-twin| {err:.3e} (tol {PAGED_TOL['store']})"
        else:
            check = paged_store_check if kw.get("store") else \
                lambda fn, kw: paged_check(kernel, fn, kw)
            msg, ok, err = check(fn, kw)
            if "_fold0_" in name:  # the retired row: every entry dead
                out, lse = fn(**kw)
                dead = not out[-1].any() and bool(
                    (lse[-1] == NEG_INF_LSE).all())
                msg += f"; the retired row out 0, lse -1e30 {dead}"
                ok = ok and dead
            lib_ms = library_ms(gathered_attention(kernel, kw), iters=3)
            torch.cuda.empty_cache()
        ms = time_ms(lambda: fn(**kw), iters=3)
        plain_ms = time_ms(lambda: twin(**kw), iters=3)
        bound = paged_roof(kernel, kw)
        lib = "none" if lib_ms is None else \
            f"{lib_ms:.4f} ms (SDPA on the K/V gathered beforehand)"
        log(f"kernel {name}: {msg} kernel {ms:.4f} ms, twin {plain_ms:.3f} "
            f"ms, bound {bound['bound_ms']:.6f} ms by {bound['bound_by']}, "
            f"library {lib}")
        if not ok:
            raise AssertionError(f"{kernel} disagrees with twin at {name}")
        records[kernel].append(dict(
            form=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
            library_ms=lib_ms, main=_is_main_paged(name, "bf16"),
            pool=next((t for t in ("int8", "int4")
                       if _is_main_paged(name, t)), None)))
        del kw
    torch.cuda.empty_cache()
    return records


def decode_resplit(plan, n: int, MP: int, ps: int):
    """``plan`` (ops/paged_attention.decode_plan) with about ``n`` splits
    of a row's MP * ps slots: whole stages of the kernel, the count then
    what they give (n >= MP * ps / 64: one stage a split, the most)."""
    from v2pe_tpu_torch.ops import paged_attention as pa

    V = max(MP * ps, 1)
    span = -(-(-(-V // max(1, n))) // pa.DECODE_SLOTS) * pa.DECODE_SLOTS
    return plan._replace(splits=-(-V // span), span=span)


PAGED_SWEEP_FORMS = 32  # seeded random forms of each of #5 and #6
PROBE_PROMPTS = [2167, 365, 98]  # the served requests' prompt lengths


def _sweep_pool(L, Hkv, NP, ps, D, kind, dtype, rng, device):
    """A random pool: values in the queries' dtype, int8 codes, or int4
    bytes (any byte is two codes), with scales for the last two."""
    shape = (L, Hkv, NP, ps, D if kind != "int4" else D // 2)
    if kind == "same":
        k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, dtype) for _ in range(2))
        return dict(k_pages=k, v_pages=v)
    k, v = (torch.from_numpy(rng.integers(-127, 128, shape).astype(
        np.int8)).to(device) for _ in range(2))
    mul = 18.0 if kind == "int4" else 1.0
    ks, vs = (torch.from_numpy((rng.uniform(0.005, 0.03, shape[:3] + (1, ps))
                                * mul).astype(np.float32)).to(device)
              for _ in range(2))
    return dict(k_pages=k, v_pages=v, k_scales=ks, v_scales=vs)


def paged_sweep_form(rng, kernel: str, device, srng=None):
    """(name, kwargs, splits) of one random form of the paged decode or
    prefill: page size 8-512, head dim 64 or 128, 1-8 rows of ragged
    lengths with some at 0 and some at 64 n + {0, 1, 63}, 1-4 kv heads of
    1-4 query heads, bf16 or fp32 queries over a pool of their dtype or of
    int8 / int4 codes, at times a dead entry inside a row's range; decode
    with T 1-16 fresh tokens stored in the pages, folded in separately, or
    left out (fold_fresh=0), the split count forced to 1 or to the most
    the plan can give (one 64-slot stage a split); prefill with 1-300 chunk
    rows. ``srng`` (its own generator, so the forms' shapes and data do
    not depend on it) makes about half of the decode forms (three in four
    of those that may: folding, or T = 1 in the pages) store their
    fresh tokens in the launch: at T = 1 with the token in the pages, or
    folding, all T or a random prefix of each row (store_n), where at
    times (T <= page size) the tables have no room left, so the longest
    row stores into its last entry, over slots the launch reads."""
    ps = int(rng.choice([8, 16, 48, 64, 128, 512]))
    D, B = int(rng.choice([64, 128])), int(rng.integers(1, 9))
    Hkv, G = int(rng.choice([1, 2, 4])), int(rng.integers(1, 5))
    dtype = [torch.bfloat16, torch.float32][int(rng.integers(2))]
    kind = ["same", "int8", "int4"][int(rng.integers(3))]
    top = 9000 if kernel == "paged_decode" else 3000
    lengths = []
    for _ in range(B):
        u = rng.random()
        n = 0 if u < 0.15 else int(rng.integers(1, top))
        if 0.15 <= u < 0.5:
            n = 64 * int(rng.integers(0, top // 64)) + int(
                rng.choice([0, 1, 63]))
        lengths.append(n)
    T = int(rng.integers(1, 17)) if kernel == "paged_decode" else \
        int(rng.integers(1, 301))
    mode = ["in_pages", "folded", "unfolded"][int(rng.integers(3))] \
        if kernel == "paged_decode" else "chunk"
    store = srng is not None and kernel == "paged_decode" and \
        srng.random() < 0.75 and (mode != "in_pages" or T == 1)
    extra = T if mode == "in_pages" else 1
    if store and mode != "in_pages":
        extra = 0 if T <= ps and srng.random() < 0.5 else T
    table, NP = _rows(lengths, ps, extra, device)
    table = table.contiguous()
    pool = _sweep_pool(2, Hkv, NP, ps, D, kind, dtype, rng, device)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    kw = dict(q=x(B, T, Hkv * G, D), page_table=table, lengths=lens,
              layer=int(rng.integers(2)), **pool)
    dead = rng.random() < 0.3 and table.shape[1] > 2
    if dead:  # another shard owns one entry inside row 0's range
        from v2pe_tpu_torch.ops import paged_attention as pa

        sb = pa.default_slot_base(table, ps)
        sb[0, int(rng.integers(0, table.shape[1]))] = -1
        kw["slot_base"] = sb.contiguous()
    splits = None
    if kernel == "paged_decode":
        kw.update(k_new=None, v_new=None, return_lse=True,
                  fresh_in_pages=mode == "in_pages")
        if mode != "in_pages":
            kw.update(k_new=x(B, T, Hkv, D), v_new=x(B, T, Hkv, D),
                      fold_fresh=int(mode == "folded"))
        splits = [1, table.shape[1] * ps][int(rng.integers(2))]
    if store:
        if mode == "in_pages":
            x = lambda *shape: torch.from_numpy(srng.standard_normal(
                shape).astype(np.float32)).to(device, dtype)
            kw.update(k_new=x(B, T, Hkv, D), v_new=x(B, T, Hkv, D))
        kw["store"] = True
        if srng.random() < 0.5:
            kw["store_n"] = torch.from_numpy(srng.integers(
                0, T + 1, B).astype(np.int32)).to(device)
        mode += f"_store{'_full' if extra == 0 else ''}"
    name = (f"B{B}_ps{ps}_{Hkv * G}/{Hkv}x{D}_T{T}_{mode}_"
            f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}_{kind}_"
            f"len{'-'.join(map(str, lengths))}{'_dead' if dead else ''}"
            + (f"_splits{splits}" if splits else ""))
    return name, kw, splits


def phase_paged_sweep(device: str = "cuda") -> dict:
    """#5 and #6 at PAGED_SWEEP_FORMS seeded random forms each
    (paged_sweep_form), held as phase_paged_kernels holds its forms: twice
    into NaN-filled outputs with equal bits, against the twin within
    PAGED_TOL (about half of #5's forms also store, their pools exactly
    equal to the twin's). One line a kernel with the count and the largest
    error."""
    from v2pe_tpu_torch.ops import paged_attention as pa

    rng, srng = np.random.default_rng(23), np.random.default_rng(29)
    records = {"paged_decode": [], "paged_prefill": []}
    plan = pa.decode_plan
    try:
        for kernel, fn in (("paged_decode", pa.paged_decode_attention),
                           ("paged_prefill", pa.paged_prefill_attention)):
            t0, worst, stored = time.perf_counter(), (0.0, ""), 0
            for _ in range(PAGED_SWEEP_FORMS):
                name, kw, splits = paged_sweep_form(rng, kernel, device,
                                                    srng)
                if splits is not None:
                    pa.decode_plan = lambda *a, n=splits: decode_resplit(
                        plan(*a), n, a[2], a[3])
                msg, ok, err = paged_store_check(fn, kw) \
                    if kw.get("store") else paged_check(kernel, fn, kw)
                pa.decode_plan = plan
                if not ok:
                    raise AssertionError(f"{kernel} sweep {name}: {msg}")
                worst = max(worst, (err, name))
                stored += bool(kw.get("store"))
                records[kernel].append(dict(form=f"sweep_{name}",
                                            max_abs_err=err, main=False))
            log(f"kernel sweep {kernel}: {PAGED_SWEEP_FORMS} seeded random "
                f"forms" + (f" ({stored} storing their fresh tokens, pools "
                            f"equal to the twin's)" if stored else "")
                + f" within PAGED_TOL, twice with equal bits; largest "
                f"error {worst[0]:.3e} at {worst[1]}; "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        pa.decode_plan = plan
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
                gc=full, tokens=tokens, answers=answers)


# ---------------------------------------------------------------- phase 4


def phase_stream(chat, cfg, served: dict, cache_mode: str = "dense",
                 kv_dtype=None) -> None:
    """stream_generate's tokens against generate's (``served["tokens"]``)
    for the same request, cache mode and pool dtype."""
    from v2pe_tpu_torch.infer.streaming import stream_generate

    stop = set(served["gc"].eos_token_ids)
    chunks = list(stream_generate(
        chat.model, cfg, served["gc"], served["ids"][None],
        served["pos"][None], served["pixels"],
        np.ones(len(served["pixels"]), np.int32),
        chat.img_context_token_id, chunk=8, cache_mode=cache_mode,
        kv_dtype=kv_dtype))
    streamed = [int(t) for c in chunks for t in c]
    generated = [int(t) for t in served["tokens"]]
    while generated and generated[-1] in stop:
        generated.pop()
    while streamed and streamed[-1] in stop:
        streamed.pop()
    log(f"stream ({cache_mode}{', ' + kv_dtype + ' pool' if kv_dtype else ''}"
        f"{', ' + chat.weights_dtype + ' weights' if chat.weights_dtype else ''}"
        f"): {len(chunks)} chunks, {len(streamed)} "
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


def _sharded(n: int):
    """The context of a pool split into ``n`` sequence shards on this card
    (``ShardingContext(seq_shards=n)``); none for one shard."""
    from v2pe_tpu_torch.parallel.context import ShardingContext, use_sharding

    return use_sharding(ShardingContext(seq_shards=n)) if n > 1 \
        else contextlib.nullcontext()


def _small_paged(model, cfg, dev: str, shards: int = 1):
    """The small model's paged path on one device: greedy tokens of a
    ragged paged generate, and the fp32 logits of two chunked prefills (the
    second over the first's pages), a 6-token step (separate-fresh fold)
    and four decode steps (store, then attend); over a pool of ``shards``
    sequence shards."""
    from v2pe_tpu_torch.infer import paged_kv as pk
    from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.models import internlm2

    m = model.to(dev)
    rng = np.random.default_rng(8)
    ids = rng.integers(3, 990, (2, 40))
    ids[1, 29:] = 0
    pos = np.broadcast_to(np.arange(40, dtype=np.float32), (2, 40)).copy()
    with _sharded(shards):
        tokens, _, lens = generate(
            m, cfg, GenerationConfig(max_new_tokens=8), torch.as_tensor(ids),
            torch.tensor([40, 29]), torch.as_tensor(pos),
            torch.zeros(1, 3, 112, 112), torch.zeros(1, dtype=torch.int32),
            999, cache_mode="paged", page_size=16)
    seq = torch.as_tensor(rng.integers(3, 990, (1, 74)), device=dev)
    lc = cfg.llm
    cache = pk.PagedKVCache.zeros(
        lc, 1, 12 if shards == 1 else shards * (-(-10 // shards) + 1), 16,
        10, dtype=torch.float32, device=dev, n_shards=shards)
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


def phase_small_shard_reference() -> None:
    """The small fp32 model's paged path and its engine over a pool of
    POOL_SHARDS sequence shards on the card (each shard's kernel launches
    merged by logsumexp) against the same on the CPU (the twins): greedy
    tokens identical, logits to 1e-4; then held against the unsharded
    run."""
    from v2pe_tpu_torch import config
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
    n = POOL_SHARDS
    (tok_cpu, lg_cpu), (tok_gpu, lg_gpu), (tok_one, lg_one) = (
        _small_paged(model, cfg, dev, shards=k)
        for dev, k in (("cpu", n), ("cuda", n), ("cuda", 1)))
    err = (lg_cpu - lg_gpu).abs().max().item()
    same = torch.equal(tok_cpu, tok_gpu)
    apart = (lg_gpu - lg_one).abs().max().item()
    log(f"reference: small paged path fp32 over {n} sequence shards (page "
        f"16), card vs CPU tokens {tok_gpu.shape[1]} x 2 identical {same}, "
        f"max|dlogit| {err:.3e} over {lg_cpu.shape[0]} positions (tol "
        f"1e-4); against one shard on the card: tokens identical "
        f"{torch.equal(tok_gpu, tok_one)}, max|dlogit| {apart:.3e} (tol "
        f"1e-4)")
    if not same or err > 1e-4 or apart > 1e-4 or \
            not torch.equal(tok_gpu, tok_one):
        raise AssertionError("sharded small paged path disagrees")
    tok = CodePointTokenizer()
    runs = {}
    for dev, k in (("cpu", n), ("cuda", n), ("cuda", 1)):
        with _sharded(k):
            runs[dev, k] = _small_engine(model, cfg, tok, dev)
    (t_cpu, s_cpu, l_cpu, alone), (t_gpu, s_gpu, l_gpu, _), \
        (t_one, s_one, _, _) = runs.values()
    err = (l_cpu - l_gpu).abs().max().item()
    ok = t_gpu == t_cpu == alone == t_one and s_gpu == s_cpu \
        and err <= 1e-4
    log(f"reference: small engine fp32 over {n} sequence shards: card "
        f"tokens equal to the CPU's {t_gpu == t_cpu}, to isolated sharded "
        f"generate {t_gpu == alone}, to one shard's {t_gpu == t_one}; stats "
        f"{s_gpu} equal {s_gpu == s_cpu} (one shard's {s_one}: a pool of "
        f"other pages evicts other prefixes); first-token max|dlogit| "
        f"{err:.3e} (tol 1e-4)")
    if not ok:
        raise AssertionError(f"sharded small engine: card {t_gpu} {s_gpu}, "
                             f"CPU {t_cpu} {s_cpu}, one shard {t_one}")


# ----------------------------------------------------- phase 6: paged serve

LOGIT_TOL = 0.1  # bf16 paths apart: max |dlogit| / max |logit|
LOGIT_TOL_FP32 = 1e-4  # fp32: summation order through 24 layers
# an int4 pool against an int8 pool (bf16 model, random weights): half a step
# of amax / 7 on every cached k and v, through 24 layers; 5.1e-2 was found
KV4_LOGIT_TOL = 0.2
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
        out = [internlm2.head_logits(hidden[:, -1], llm.output)]
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
    require(counts, ("flash_fwd",), "paged serve")
    require_riding_store(counts, "paged serve")

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
    over a 32k-token history, timed, over a bf16 and an int8 pool."""
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
            require(counts, ("paged_prefill",), f"session turn {i + 1}")
            require_riding_store(counts, f"session turn {i + 1}")
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

    for kv in (None, "int8"):
        long = long_session(chat, cfg, kv,
                            f"bf16 weights, {kv or 'bf16'} pool")
        total = {k: total[k] + long[k] for k in total}
    return total


def session_decode(sess, cfg):
    """The decode rate of a ChatSession at its context: a turn of 33 new
    tokens less a turn of one, steps counted from the decode kernel's
    launches. Returns (steps, seconds of the 33-token turn, of the 1-token
    turn, the launch counts of the 33-token turn)."""
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    t0 = time.perf_counter()
    sess.send(None, "Go on.", GenerationConfig(max_new_tokens=1))
    t_one = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    sess.send(None, "Go on again.", GenerationConfig(max_new_tokens=33))
    counts = read_launches()
    t_many = time.perf_counter() - t0
    return (counts["paged_decode"] // cfg.llm.num_hidden_layers, t_many,
            t_one, counts)


def long_session(chat, cfg, kv_dtype, tag: str) -> dict:
    """A 2k-token turn over a 32k-token history through ChatSession at page
    512, timed to its first token, then the decode rate at that context (34k
    tokens). Returns the launch counts of the turn and the decode."""
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.infer.session import ChatSession

    rng = np.random.default_rng(12)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    long_sess = ChatSession(chat, max_len=LONG_HISTORY + 2 * LONG_TURN,
                            page_size=512, kv_dtype=kv_dtype)
    pool = long_sess.cache
    log(f"session ({tag}): pool of {pool.k_pages.shape[2]} pages of 512: "
        f"{2 * nbytes(pool.k_pages) / 2 ** 30:.3f} GiB of k and v, "
        f"{2 * nbytes(pool.k_scales) / 2 ** 30:.3f} GiB of scales")
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
    log(f"session ({tag}): {long_sess.consumed - history}-token turn over a "
        f"{history}-token history: {turn * 1e3:.1f} ms to the first token "
        f"(history prefill {fill * 1e3:.1f} ms); launches {counts}")
    require(counts, ("paged_prefill",), f"2k-over-32k turn ({tag})")
    steps, t_many, t_one, decode = session_decode(long_sess, cfg)
    log(f"session ({tag}): decode over a {long_sess.consumed}-token context: "
        f"{steps} steps in {(t_many - t_one) * 1e3:.1f} ms = "
        f"{steps / (t_many - t_one):.1f} tok/s (a {t_many * 1e3:.1f} ms turn "
        f"less a 1-token turn of {t_one * 1e3:.1f} ms)")
    require_riding_store(decode, f"34k decode ({tag})")
    return {k: counts[k] + decode[k] for k in counts}


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
    require_riding_store(counts, "worker")
    return counts


# ------------------------------------------------- phase 12: the engine


def count_syncs(fn):
    """Run ``fn`` with PyTorch's synchronisation debug mode on: (its
    result, how many synchronising CUDA calls the host made: reads of a
    device value, blocking copies)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in caught)


def _small_engine(model, cfg, tok, dev: str, kv_dtype=None,
                  speculative_k: int = 0):
    """A 2-row engine on ``dev`` whose pool cannot hold all of its 5
    requests at once: requests queue, rows are reused, pages are reclaimed,
    and the fourth request repeats the first's prefix. Returns (tokens per
    request, stats, first-token logits of request 0, the isolated paged
    generate's tokens per request)."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    chat = ChatModel(model.to(dev), cfg, tok, cache_mode="paged",
                     page_size=16, kv_dtype=kv_dtype)
    gc = GenerationConfig(eos_token_ids=(cfg.llm.vocab_size - 1,),
                          speculative_k=speculative_k, speculative_ngram=2)
    # spec_min_accept 0: every block of a speculative engine verifies
    eng = InferenceEngine(chat, max_rows=2, max_len=160, page_size=16,
                          pool_tokens=240, chunk_size=32, decode_block=4,
                          generation_config=gc, kv_dtype=kv_dtype,
                          spec_min_accept=0.0)
    rng = np.random.default_rng(21)
    base = rng.integers(3, 990, 70)
    prompts = [base, rng.integers(3, 990, 41), rng.integers(3, 990, 23),
               np.concatenate([base[:50], rng.integers(3, 990, 9)]),
               np.tile(rng.integers(3, 990, 6), 6)]
    new = [11, 9, 14, 8, 12]
    reqs = [eng.submit(p, np.arange(len(p)) * 0.5, max_new_tokens=n)
            for p, n in zip(prompts, new)]
    eng.run_until_idle()
    alone = []
    for p, n in zip(prompts, new):
        out, _, lens = generate(
            chat.model, cfg, dataclasses.replace(
                gc, max_new_tokens=n, speculative_k=0),
            torch.as_tensor(p[None]), torch.tensor([len(p)]),
            torch.as_tensor((np.arange(len(p)) * 0.5)[None]),
            torch.zeros(1, 3, 112, 112), torch.zeros(1, dtype=torch.int32),
            999, cache_mode="paged", page_size=16, kv_dtype=kv_dtype)
        alone.append(out[0, :int(lens[0])].tolist())
    return ([r.tokens for r in reqs], dict(eng.stats),
            reqs[0].first_logits.float().cpu(), alone)


def phase_small_engine_reference() -> None:
    """The continuous-batching engine on a small fp32 model, on the card
    (through the paged kernels) against the CPU (through their plain
    versions): the same tokens, equal to each request's isolated paged
    generate; the same with speculative_k = 4; an int4 pool's first-token
    logits card against CPU. Then beam search, card against CPU."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.infer.beam import beam_generate
    from v2pe_tpu_torch.infer.generate import GenerationConfig
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
    tok = CodePointTokenizer()
    for k in (0, 4):
        (t_cpu, s_cpu, l_cpu, alone), (t_gpu, s_gpu, l_gpu, _) = (
            _small_engine(model, cfg, tok, dev, speculative_k=k)
            for dev in ("cpu", "cuda"))
        err = (l_cpu - l_gpu).abs().max().item()
        ok = t_gpu == t_cpu == alone and s_gpu == s_cpu \
            and s_gpu["prefix_hit_pages"] > 0 and err <= 1e-4
        log(f"reference: small engine fp32 (2 rows, 5 requests, pool of 15 "
            f"pages of 16, speculative_k {k}): card tokens equal to the "
            f"CPU's {t_gpu == t_cpu}, to isolated paged generate "
            f"{t_gpu == alone}; stats {s_gpu} equal {s_gpu == s_cpu}; "
            f"first-token max|dlogit| {err:.3e} (tol 1e-4)")
        if not ok:
            raise AssertionError(f"small engine: card {t_gpu} {s_gpu}, CPU "
                                 f"{t_cpu} {s_cpu}, alone {alone}")
    (t_cpu, _, l_cpu, _), (t_gpu, _, l_gpu, _) = (
        _small_engine(model, cfg, tok, dev, kv_dtype="int4")
        for dev in ("cpu", "cuda"))
    rel = _rel(l_gpu, l_cpu)
    same = sum(a == b for a, b in zip(sum(t_gpu, []), sum(t_cpu, [])))
    log(f"reference: small engine fp32, int4 pool: first-token logits card "
        f"vs CPU max|dlogit|/max|logit| {rel:.3e} (tol 2e-3), equal tokens "
        f"{same}/{len(sum(t_cpu, []))}")
    if not rel <= 2e-3:
        raise AssertionError("small int4 engine: card and CPU disagree")

    rng = np.random.default_rng(31)
    ids = rng.integers(3, 990, (2, 30))
    ids[1, 19:] = 0
    gc = GenerationConfig(max_new_tokens=10, num_beams=3, eos_token_ids=(7,))
    outs = []
    for dev in ("cpu", "cuda"):
        tokens, lens = beam_generate(
            model.to(dev), cfg, gc, torch.as_tensor(ids),
            torch.tensor([30, 19]),
            torch.as_tensor(np.broadcast_to(np.arange(30, dtype=np.float32),
                                            (2, 30)).copy()),
            torch.zeros(1, 3, 112, 112), torch.zeros(1, dtype=torch.int32),
            999)
        outs.append((tokens.cpu(), lens.cpu()))
    same = torch.equal(outs[0][0], outs[1][0]) and \
        torch.equal(outs[0][1], outs[1][1])
    log(f"reference: small beam search fp32 (3 beams, 2 rows): card tokens "
        f"and lengths {outs[1][1].tolist()} equal to the CPU's {same}")
    if not same:
        raise AssertionError(f"beam search: card {outs[1]} CPU {outs[0]}")


ENGINE_ROWS, ENGINE_NEW, ENGINE_BLOCK = 8, 256, 64


def engine_recipe(chat, cfg, **kw):
    """The serving-throughput recipe of the JAX package's bench
    (``bench.py:_engine_bench``): 8 rows, prompts of 8192 random tokens,
    256 new each, page 512, chunks of 2048, blocks of 64 steps, no prefix
    cache, the last vocabulary id as the stop token."""
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    gc = GenerationConfig(max_new_tokens=ENGINE_NEW,
                          eos_token_ids=(cfg.llm.vocab_size - 1,))
    max_len = ENGINE_CONTEXT + ENGINE_NEW + 16
    # a pool of whole pages for every row: the recipe's default (max_rows *
    # max_len tokens) is 133 pages where 8 rows reserve 8 x 17, so its
    # eighth request would wait for a row to finish
    return InferenceEngine(
        chat, max_rows=ENGINE_ROWS, max_len=max_len, page_size=512,
        pool_tokens=ENGINE_ROWS * -(-max_len // 512) * 512,
        chunk_size=2048, decode_block=ENGINE_BLOCK, generation_config=gc,
        prefix_caching=False, **kw)


def _engine_submit(eng, cfg, rng, n: int, max_new: int) -> list:
    return [eng.submit(rng.integers(10, cfg.llm.vocab_size - 2,
                                    ENGINE_CONTEXT),
                       np.arange(ENGINE_CONTEXT, dtype=np.float64),
                       max_new_tokens=max_new) for _ in range(n)]


def phase_engine(chat, cfg) -> dict:
    """The engine at full width through the bench recipe: a short warm run
    (one request, which also times an admission), then 8 requests of 8192
    tokens and 256 new each, run once. Every block after the admissions is
    run with the synchronisation counter on: one harvest a block."""
    L = cfg.llm.num_hidden_layers
    eng = engine_recipe(chat, cfg)
    pool = eng.cache
    log(f"engine: pool of {pool.k_pages.shape[2]} pages of "
        f"{pool.page_size} ({eng.max_pages_per_row} a row): "
        f"{2 * nbytes(pool.k_pages) / 2 ** 30:.3f} GiB")
    rng = np.random.default_rng(0)
    eng.decode_block = 1
    for label in ("warm", "timed"):
        _engine_submit(eng, cfg, rng, 1, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        admit = time.perf_counter() - t0
        eng.run_until_idle()
    log(f"engine: admission of one {ENGINE_CONTEXT}-token request "
        f"({ENGINE_CONTEXT // eng.chunk_size} chunks of {eng.chunk_size}) "
        f"and one decode step: {admit * 1e3:.1f} ms")
    eng.decode_block = ENGINE_BLOCK
    eng.stats["prefill_chunks"] = 0

    reqs = _engine_submit(eng, cfg, rng, ENGINE_ROWS, ENGINE_NEW)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng.step()                      # admits all 8, then the first block
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    first = read_launches()
    blocks = []
    while any(r is not None for r in eng._row_req):
        reset_launches()
        t1 = time.perf_counter()
        _, syncs = count_syncs(eng.step)
        torch.cuda.synchronize()
        blocks.append((time.perf_counter() - t1, syncs, read_launches()))
    dt = time.perf_counter() - t0
    generated = sum(len(r.tokens) for r in reqs)
    total = ENGINE_ROWS * ENGINE_CONTEXT + generated
    # every block runs its 64 steps over all rows, active or not
    step_ms = 1e3 * sum(b[0] for b in blocks) / (len(blocks) * ENGINE_BLOCK)
    log(f"engine: {ENGINE_ROWS} requests x {ENGINE_CONTEXT} tokens, "
        f"{generated} generated in {dt:.3f}s = {total / dt:.1f} total tok/s,"
        f" {generated / dt:.1f} generated tok/s; admissions and the first "
        f"block {t_first:.3f}s ({eng.stats['prefill_chunks']} chunks); then "
        f"{len(blocks)} blocks of {ENGINE_BLOCK} steps: {step_ms:.2f} ms a "
        f"step at {ENGINE_ROWS} rows = "
        f"{ENGINE_ROWS / step_ms * 1e3:.1f} tok/s in decode; a block "
        f"launches {blocks[0][2]['paged_store']} stores of their own and "
        f"{blocks[0][2]['paged_decode']} decodes, "
        f"{blocks[0][2]['paged_decode_store']} of them storing, and reads "
        f"the card {sorted({b[1] for b in blocks})} time(s)")
    require(first, ("flash_fwd", "paged_prefill"), "engine admissions")
    require_riding_store(first, "engine admissions")
    if generated != ENGINE_ROWS * ENGINE_NEW or \
            not all(r.finished.is_set() for r in reqs):
        raise AssertionError(f"engine generated {generated} tokens")
    if any(b[1] != 1 for b in blocks):
        raise AssertionError(f"a decode block synchronised "
                             f"{[b[1] for b in blocks]} times, not once")
    for b in blocks:
        if not (b[2]["paged_store"] == 0 and b[2]["paged_decode_store"]
                == b[2]["paged_decode"] == L * ENGINE_BLOCK):
            raise AssertionError(f"block launches {b[2]}")
    counts = dict(first)
    for b in blocks:
        counts = {k: counts[k] + b[2][k] for k in counts}
    return counts


CHAT_REQUESTS = REQUESTS + REQUESTS[:1]  # the 8-tile request comes again


def _engine_chats(chat, cfg, tag: str, **engine_kw):
    """The three served requests and the 8-tile one again through an
    EngineChat with the prefix cache on (page 128, chunks of 512): (requests,
    launch counts, stats)."""
    from v2pe_tpu_torch.serve.engine import EngineChat

    pixels = _request_pixels()
    pixels.append(pixels[0])
    ec = EngineChat(chat, max_rows=4, max_len=4096, page_size=128,
                    chunk_size=512, decode_block=8, **engine_kw)
    try:
        reset_launches()
        t0 = time.perf_counter()
        reqs = [ec.engine.submit_chat(pv, q, max_new_tokens=MAX_NEW)
                for pv, (_, q) in zip(pixels[:3], CHAT_REQUESTS[:3])]
        for r in reqs:
            r.result(timeout=600)
        cold = dict(ec.engine.stats)
        reqs.append(ec.engine.submit_chat(pixels[3], CHAT_REQUESTS[3][1],
                                          max_new_tokens=MAX_NEW))
        reqs[3].result(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_launches()
        stats = dict(ec.engine.stats)
        pool = ec.engine.cache
        stats["pool_bytes"] = 2 * nbytes(pool.k_pages)
    finally:
        ec.stop()
    again = stats["prefill_chunks"] - cold["prefill_chunks"]
    log(f"engine chat ({tag}): pool of {pool.k_pages.shape[2]} pages of "
        f"{pool.page_size}: {stats['pool_bytes']} bytes of k and v, "
        f"{2 * nbytes(pool.k_scales)} of scales; 4 requests in {wall:.3f}s, tokens "
        f"{[len(r.tokens) for r in reqs]}; the first three ran "
        f"{cold['prefill_chunks']} prefill chunks, the 8-tile request again "
        f"{again} with {stats['prefix_hit_pages']} prefix pages hit; stats "
        f"{stats}; launches {counts}")
    if not (stats["prefix_hit_pages"] > 0 and again < 5
            and all(r.tokens for r in reqs)):
        raise AssertionError(f"engine chat ({tag}): no prefix hit: {stats}")
    return reqs, counts, stats


def _token_share(a, b) -> str:
    pairs = [(x, y) for r, s in zip(a, b) for x, y in zip(r.tokens, s.tokens)]
    return f"{sum(x == y for x, y in pairs)}/{len(pairs)}"


def phase_engine_chat(model, cfg, tok, served: dict) -> list:
    """Chat requests through EngineChat at full width: bf16 pool (held to
    the isolated paged chat: first-token logits within the bf16 limit, the
    share of equal tokens printed; the repeated request to its first run),
    then an int8 and an int4 pool (int4 against int8), then
    speculative_k = 4; then one request over HTTP through
    ModelWorker(engine=...). Returns the launch counts of each path."""
    import threading
    import urllib.request

    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.serve.engine import InferenceEngine
    from v2pe_tpu_torch.serve.worker import ModelWorker

    chat = ChatModel(model, cfg, tok, cache_mode="paged")
    ids, pos, pix = served["ids"], served["pos"], served["pixels"]
    paths = []
    bf16, counts, _ = _engine_chats(chat, cfg, "bf16 pool")
    require(counts, ("flash_fwd", "paged_prefill"), "engine chat")
    require_riding_store(counts, "engine chat")
    paths.append(counts)
    alone = first_logits(chat, cfg, ids, pos, pix, [], "paged", steps=0)[0]
    d = _rel(bf16[0].first_logits.float(), alone)
    d_again = _rel(bf16[3].first_logits.float(), bf16[0].first_logits.float())
    same = sum(x == int(y) for x, y in zip(bf16[0].tokens, served["tokens"]))
    log(f"engine chat: 8-tile request's first-token logits vs the isolated "
        f"paged prefill: max|dlogit|/max|logit| {d:.3e}; on its prefix hit "
        f"vs its cold run {d_again:.3e} (tol {LOGIT_TOL}); tokens equal to "
        f"the isolated generate's {same}/{len(bf16[0].tokens)}, hit vs cold "
        f"{_token_share(bf16[3:], bf16[:1])}")
    if not (d <= LOGIT_TOL and d_again <= LOGIT_TOL):
        raise AssertionError("engine chat disagrees with the isolated chat")

    pools, held = {}, {}
    for kv in ("int8", "int4"):
        pools[kv], counts, stats = _engine_chats(chat, cfg, f"{kv} pool",
                                                 kv_dtype=kv)
        require(counts, ("flash_fwd", "paged_prefill"),
                f"engine chat ({kv} pool)")
        require_riding_store(counts, f"engine chat ({kv} pool)")
        paths.append(counts)
        held[kv] = stats["pool_bytes"]
    if 2 * held["int4"] != held["int8"]:
        raise AssertionError(f"the int4 pool holds {held['int4']} bytes, the "
                             f"int8 pool {held['int8']}: not half")
    d = max(_rel(a.first_logits.float(), b.first_logits.float())
            for a, b in zip(pools["int4"], pools["int8"]))
    finite = all(bool(torch.isfinite(r.first_logits).all())
                 for r in pools["int4"])
    log(f"engine chat: int4 pool vs int8 pool, first-token logits of the 4 "
        f"requests: max|dlogit|/max|logit| {d:.3e} (tol {KV4_LOGIT_TOL}), "
        f"finite {finite}; equal tokens "
        f"{_token_share(pools['int4'], pools['int8'])}; int8 vs bf16 "
        f"{_token_share(pools['int8'], bf16)}; the int4 pool's k and v take "
        f"{held['int4']} bytes, half the int8 pool's {held['int8']}")
    if not (finite and d <= KV4_LOGIT_TOL):
        raise AssertionError("int4 pool disagrees with the int8 pool")

    spec, counts, stats = _engine_chats(
        chat, cfg, "bf16 pool, speculative_k 4",
        generation_config=GenerationConfig(speculative_k=4,
                                           speculative_ngram=3))
    require(counts, ("flash_fwd", "paged_prefill"),
            "engine chat (speculative)")
    require_riding_store(counts, "engine chat (speculative)")
    paths.append(counts)
    log(f"engine chat: speculative_k 4 vs plain, equal tokens "
        f"{_token_share(spec, bf16)}; {stats.get('spec_accepted', 0)} tokens "
        f"from {stats.get('spec_forwards', 0)} verify forwards, "
        f"{stats.get('spec_suspends', 0)} suspends")
    if not stats.get("spec_forwards"):
        raise AssertionError("the speculative engine ran no verify forward")

    question, n_new = "Write a haiku about the sea.", 24
    want = chat.chat(None, question, GenerationConfig(max_new_tokens=n_new))
    engine = InferenceEngine(chat, max_rows=4, max_len=2048, page_size=128,
                             chunk_size=512, decode_block=8)
    server = ModelWorker(chat, model_name="internvl2-2b",
                         engine=engine).make_server(host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        reset_launches()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}"
            "/worker_generate_stream", data=json.dumps({
                "prompt": chat.build_query(question, []),
                "max_new_tokens": n_new, "temperature": 0.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            raw = r.read()
        counts = read_launches()
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
        engine.stop()
    chunks = [json.loads(c) for c in raw.split(b"\0") if c]
    got = chunks[-1]["text"].strip() if chunks else ""
    n = min(len(got), len(want))
    agree = next((i for i in range(n) if got[i] != want[i]), n)
    log(f"worker over the engine: {len(chunks)} chunks, {len(got)} chars, "
        f"the first {agree} equal to chat()'s {len(want)}; launches {counts}")
    if not (chunks and all(c["error_code"] == 0 for c in chunks) and got):
        raise AssertionError(f"worker over the engine: {chunks[-3:]}")
    require_riding_store(counts, "worker over the engine")
    paths.append(counts)
    return paths


def phase_w4kv4(quantized, cfg, tok) -> dict:
    """int4 weights over an int4 pool: the 32k-history session of phase 7
    once more (the 2k turn, decode at 34k)."""
    from v2pe_tpu_torch.infer.chat import ChatModel

    chat = ChatModel(quantized, cfg, tok, cache_mode="paged",
                     kv_dtype="int4")
    counts = long_session(chat, cfg, "int4", "w4kv4: int4 weights, int4 pool")
    require(counts, ("q4dot", "q4dot_stacked"), "w4kv4 session")
    return counts


def phase_spec_reads(chat, cfg) -> dict:
    """Reads of the card on the speculative paths at full width, now that
    a verify forward's K+1 fresh tokens are stored by its decode launches:
    a speculative engine block of 8 verify iterations over 2 rows, and
    ``speculative_decode_from_logits`` under ``generate``, each counted
    with ``count_syncs``. Beside it is printed the count of the same path
    with the store done apart, as chunked prefill still does it
    (``paged_kv.token_slots`` once and ``scatter_layers`` a layer, each of
    which reads a mask back): this count plus, a verify forward, the reads
    of one ``token_slots`` call and of L ``scatter_layers`` calls, measured
    here on a scratch pool. Returns the launch counts of the engine's
    blocks."""
    from v2pe_tpu_torch.infer import paged_kv, speculative
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    L, V = cfg.llm.num_hidden_layers, cfg.llm.vocab_size
    rng = np.random.default_rng(31)
    # a prompt that repeats itself, so that prompt-lookup drafts are taken
    # (ids below the tokenizer's special ones)
    prompt = np.tile(rng.integers(10, 90000, 48), 16)
    gc = GenerationConfig(max_new_tokens=96, speculative_k=4,
                          speculative_ngram=3, eos_token_ids=(V - 1,))
    eng = InferenceEngine(chat, max_rows=2, max_len=2048, page_size=128,
                          chunk_size=512, decode_block=8,
                          generation_config=gc, prefix_caching=False,
                          spec_min_accept=0.0)
    for _ in range(2):
        eng.submit(prompt, np.arange(len(prompt), dtype=np.float64),
                   max_new_tokens=96)
    eng.step()  # both admissions and the first block
    blocks, counts = [], None
    while any(r is not None for r in eng._row_req):
        reset_launches()
        _, syncs = count_syncs(eng.step)
        c = read_launches()
        blocks.append(syncs)
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    forwards = eng.stats.get("spec_forwards", 0)
    # the reads a verify forward of the store done apart, on a scratch pool
    # of 2 rows
    K1, dev = gc.speculative_k + 1, eng.cache.lengths.device
    scratch = paged_kv.allocate_rows(
        paged_kv.PagedKVCache.zeros(cfg.llm, 2, 4, 128, 2,
                                    dtype=torch.bfloat16, device=dev),
        torch.full((2,), K1, dtype=torch.int32, device=dev))
    valid = torch.ones((2, K1), dtype=torch.bool, device=dev)
    slots, slot_reads = count_syncs(
        lambda: paged_kv.token_slots(scratch, K1, valid))
    kv = torch.zeros((1, 2, K1, cfg.llm.num_key_value_heads,
                      cfg.llm.head_dim), dtype=torch.bfloat16, device=dev)
    _, scatter_reads = count_syncs(lambda: paged_kv.scatter_layers(
        scratch, slice(0, 1), kv, kv, slots))
    per_forward = slot_reads + L * scatter_reads
    del scratch
    log(f"speculative reads (engine): {len(blocks)} blocks of "
        f"{eng.decode_block} verify forwards after the admissions read the "
        f"card {blocks} time(s); stored apart "
        f"{[b + eng.decode_block * per_forward for b in blocks]} "
        f"({per_forward} a verify forward: token_slots {slot_reads}, "
        f"scatter_layers {scatter_reads} a layer, bf16 pool); "
        f"{eng.stats.get('spec_accepted', 0)} tokens from {forwards} verify "
        f"forwards; launches {counts}")
    if not blocks or any(b != 1 for b in blocks):
        raise AssertionError(f"a speculative block read the card {blocks} "
                             f"times, not once")
    require_riding_store(counts, "speculative engine blocks")
    if counts["paged_decode"] != L * eng.decode_block * len(blocks):
        raise AssertionError(f"speculative blocks launched {counts}")

    own, seen = speculative.speculative_decode_from_logits, {}

    def counted(*a, **kw):
        reset_launches()
        res, seen["reads"] = count_syncs(lambda: own(*a, **kw))
        seen["launches"] = read_launches()
        return res

    speculative.speculative_decode_from_logits = counted
    try:
        w = next(chat.model.parameters())
        dev = w.device
        out, steps, lens = generate(
            chat.model, cfg, gc, torch.as_tensor(prompt[None], device=dev),
            torch.tensor([len(prompt)], device=dev),
            torch.arange(len(prompt), dtype=torch.float32,
                         device=dev)[None],
            torch.zeros((1, 3, cfg.vision.image_size, cfg.vision.image_size),
                        dtype=w.dtype, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            chat.img_context_token_id, cache_mode="paged", page_size=128)
    finally:
        speculative.speculative_decode_from_logits = own
    log(f"speculative reads (speculative_decode_from_logits): {steps} "
        f"verify forwards, {int(lens[0])} tokens, read the card "
        f"{seen['reads']} time(s) (the loop's test {steps + 1} times and "
        f"the stop ids' copy to the card); stored apart "
        f"{seen['reads'] + steps * per_forward}; launches "
        f"{seen['launches']}")
    if seen["reads"] > steps + 2:
        raise AssertionError(f"speculative decode read the card "
                             f"{seen['reads']} times in {steps} verify "
                             f"forwards")
    require_riding_store(seen["launches"], "speculative decode")
    return counts


SHARD_ROWS, SHARD_NEW = 4, 64            # the sharded engine's rows
SHARD_LONG, SHARD_LONG_NEW = 32768, 32   # the long prompt's tokens


def shard_engine(chat, cfg, n: int, rows: int, context: int, new: int):
    """``rows`` requests of ``context`` random tokens and ``new`` new each
    through an engine built over ``n`` sequence shards (page 512, chunks of
    2048, blocks of 64 steps, every row's pages reserved): (requests,
    launches, seconds, the pool)."""
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    V = cfg.llm.vocab_size
    max_len = context + new + 16
    with _sharded(n):
        eng = InferenceEngine(
            chat, max_rows=rows, max_len=max_len, page_size=512,
            pool_tokens=rows * -(-max_len // 512) * 512, chunk_size=2048,
            decode_block=64, prefix_caching=False,
            generation_config=GenerationConfig(max_new_tokens=new,
                                               eos_token_ids=(V - 1,)))
        rng = np.random.default_rng(41)
        reqs = [eng.submit(rng.integers(10, V - 2, context),
                           np.arange(context, dtype=np.float64),
                           max_new_tokens=new) for _ in range(rows)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        eng.run_until_idle()
        counts = read_launches()
        dt = time.perf_counter() - t0
    if eng.cache.n_shards != n or eng.allocator.n_shards != n:
        raise AssertionError(f"engine pool of {eng.cache.n_shards} shards")
    return reqs, counts, dt, eng.cache


def _generated(chat, cfg, served, n: int, **kw):
    """The 8-tile request's greedy tokens through paged generate over ``n``
    sequence shards, and the launches of that run."""
    from v2pe_tpu_torch.infer.generate import generate

    pix = served["pixels"]
    args = (torch.as_tensor(served["ids"][None]),
            torch.tensor([len(served["ids"])]),
            torch.as_tensor(served["pos"][None]), torch.as_tensor(pix),
            torch.ones(len(pix), dtype=torch.int32),
            chat.img_context_token_id)
    with _sharded(n):
        reset_launches()
        out, _, lens = generate(chat.model, cfg, served["gc"], *args,
                                cache_mode="paged", page_size=128, **kw)
        counts = read_launches()
    return out[0, :int(lens[0])].cpu(), counts


def _shared(a, b) -> str:
    """Equal greedy tokens of two streams, position by position."""
    return f"{sum(int(x == y) for x, y in zip(a, b))}/{max(len(a), len(b))}"


def phase_seq_shards(model, cfg, tok, served: dict) -> list:
    """Serving over a pool split into POOL_SHARDS sequence shards on this
    card (``ShardingContext(seq_shards=4)``: each shard's pages behind its
    own compacted table, one #5 / #6 launch a shard and layer, merged by
    logsumexp; the store riding in each shard's decode launch with
    ``fresh_pages``), each path against the unsharded run of the same
    requests in this process: batch_chat of the three served requests (each
    answer's greedy tokens against one shard's) and the 8-tile request's
    logits (prefill and 4 decode steps) and greedy
    tokens; the engine on 4 rows of 8192-token prompts and 64 new tokens;
    one 32,768-token prompt through the engine's chunked prefill and 32
    decode steps; int8 weights over an int8 pool (w8kv8). Logits within
    LOGIT_TOL (bf16: other sums); equal tokens printed, not required.
    Returns the sharded paths' launches."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    n, paths = POOL_SHARDS, []
    L = cfg.llm.num_hidden_layers
    chat = ChatModel(model, cfg, tok, cache_mode="paged")
    pixels = _request_pixels()
    decode, ids = chat._decode, {}
    dt, launches = {}, {}
    for k in (1, n):
        # each answer's greedy tokens, as chat() detokenizes them
        ids[k] = []
        chat._decode = lambda t, m, got=ids[k]: \
            got.append([int(x) for x in t[:m]]) or decode(t, m)
        with _sharded(k):
            reset_launches()
            t0 = time.perf_counter()
            chat.batch_chat(pixels, [q for _, q in REQUESTS],
                            GenerationConfig(max_new_tokens=MAX_NEW))
            launches[k] = read_launches()
        dt[k] = time.perf_counter() - t0
    del chat._decode
    counts = launches[n]
    log(f"seq shards ({n}, batch_chat): 3 requests in {dt[n]:.3f}s (one "
        f"shard {dt[1]:.3f}s); greedy tokens equal to one shard's "
        f"{[_shared(a, b) for a, b in zip(ids[n], ids[1])]}; launches "
        f"{counts} against one shard's {launches[1]}")
    require(counts, ("flash_fwd", "paged_decode"), "seq shards batch_chat")
    require_riding_store(counts, "seq shards batch_chat")
    paths.append(counts)

    ids, pos, pix = served["ids"], served["pos"], served["pixels"]
    for name, m, kv in (("bf16", chat, None), ("w8kv8", None, "int8")):
        if m is None:
            m = ChatModel(model, cfg, tok, cache_mode="paged", kv_dtype=kv,
                          weights_dtype="int8")
        logits, toks, counts = {}, {}, {}
        for k in (1, n):
            with _sharded(k):
                logits[k] = first_logits(m, cfg, ids, pos, pix,
                                         served["tokens"], "paged",
                                         kv_dtype=kv)
            toks[k], counts[k] = _generated(m, cfg, served, k, kv_dtype=kv)
        rel = _rel(logits[n], logits[1])
        log(f"seq shards ({n}, {name}): the 8-tile request's logits "
            f"(prefill + {DECODE_STEPS} steps) against one shard: "
            f"max|dlogit|/max|logit| {rel:.3e} (tol {LOGIT_TOL}); greedy "
            f"tokens equal {_shared(toks[n], toks[1])}; launches {counts[n]}"
            f" against one shard's {counts[1]}")
        if rel > LOGIT_TOL:
            raise AssertionError(f"seq shards ({name}): logits apart")
        require_riding_store(counts[n], f"seq shards ({name})")
        if name == "w8kv8":
            require(counts[n], ("qdot", "qdot_stacked"), "seq shards w8kv8")
        # a decode step launches #5 once a shard and layer
        if counts[n]["paged_decode"] != n * L * (len(toks[n]) - 1) or \
                counts[1]["paged_decode"] != L * (len(toks[1]) - 1):
            raise AssertionError(f"seq shards ({name}): {counts[n]} "
                                 f"against {counts[1]}")
        paths.append(counts[n])
        del m
    torch.cuda.empty_cache()

    for label, rows, context, new in (
            ("engine", SHARD_ROWS, ENGINE_CONTEXT, SHARD_NEW),
            ("engine, long prompt", 1, SHARD_LONG, SHARD_LONG_NEW)):
        runs = {k: shard_engine(chat, cfg, k, rows, context, new)
                for k in (1, n)}
        (reqs1, c1, dt1, pool1), (reqs, counts, dt, pool) = runs.values()
        rel = max(_rel(a.first_logits.float(), b.first_logits.float())
                  for a, b in zip(reqs, reqs1))
        gen = sum(len(r.tokens) for r in reqs)
        log(f"seq shards ({n}, {label}): {rows} x {context} tokens, {gen} "
            f"generated in {dt:.3f}s ({(rows * context + gen) / dt:.1f} "
            f"tok/s; one shard {dt1:.3f}s); pool {tuple(pool.k_pages.shape)}"
            f" over {pool.n_shards} shards against {tuple(pool1.k_pages.shape)}"
            f"; first-token logits against one shard max|dlogit|/max|logit| "
            f"{rel:.3e} (tol {LOGIT_TOL}); greedy tokens equal "
            f"{_shared(sum((r.tokens for r in reqs), []), sum((r.tokens for r in reqs1), []))}"
            f"; launches {counts} against {c1}")
        if rel > LOGIT_TOL or gen != rows * new:
            raise AssertionError(f"seq shards ({label}): {rel} {gen}")
        require(counts, ("flash_fwd", "paged_prefill", "paged_decode"),
                f"seq shards ({label})")
        require_riding_store(counts, f"seq shards ({label})")
        if counts["paged_decode"] % (n * L) or \
                c1["paged_decode"] % L:
            raise AssertionError(f"seq shards ({label}): {counts}")
        paths.append(counts)
        del runs, pool, pool1
        torch.cuda.empty_cache()
    return paths


def phase_beam(chat, cfg) -> None:
    """One text request with 3 beams at full width (a dense 3-row cache)."""
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    _, question = REQUESTS[2]
    t0 = time.perf_counter()
    answer = chat.chat(None, question, GenerationConfig(
        max_new_tokens=MAX_NEW, num_beams=3))
    torch.cuda.synchronize()
    log(f"beam search: 3 beams, up to {MAX_NEW} tokens in "
        f"{time.perf_counter() - t0:.3f}s; answer {len(answer)} chars")
    if not isinstance(answer, str):
        raise AssertionError("beam search returned no text")


# ----------------------------------------------------- checkpoint and eval

EVAL_CONTEXTS = [1000, 2000, 3000, 4000, 6000, 8000, 12000, 16000]
EVAL_DEPTHS = [0.1, 0.9, 0.5, 0.3, 0.7, 0.2, 0.6, 0.95]
EVAL_ROWS = 4         # --engine-rows of the engine route
EVAL_MAX_LEN = 17408  # --engine-max-len: the longest prompt and its answer
EVAL_TASK = "retrieval-text-test"


def needle_items(seed: int = 0) -> list:
    """Made-up text-only MM-NIAH retrieval items, one a context length of
    ``EVAL_CONTEXTS`` (characters, one token each under CodePointTokenizer):
    a haystack of random words with a magic number at a depth."""
    rng = np.random.default_rng(seed)
    words = ["grass", "river", "stone", "cloud", "paper", "light", "table",
             "green", "quiet", "north", "seven", "apple"]
    items = []
    for i, (n, depth) in enumerate(zip(EVAL_CONTEXTS, EVAL_DEPTHS)):
        number = int(rng.integers(1000, 10000))
        needle = f" The special magic number is {number}. "
        hay = " ".join(rng.choice(words, size=n // 5))[:n - len(needle)]
        at = int(len(hay) * depth)
        context = hay[:at] + needle + hay[at:]
        items.append({
            "id": i, "context": context, "images_list": [],
            "question": "\nWhat is the special magic number in the text? "
                        "Answer with the number only.",
            "answer": str(number),
            "meta": {"context_length": len(context), "placed_depth": depth}})
    return items


class RecordingTokenizer(CodePointTokenizer):
    """A CodePointTokenizer that keeps the ids of each text it decodes: the
    eval CLI writes text, and a route's tokens are read back from it. A
    surrogate code point, which UTF-8 cannot write, decodes as U+FFFD."""

    def __init__(self):
        self.ids_of = {}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        text = "".join("\ufffd" if 0xD800 <= ord(c) < 0xE000 else c
                       for c in super().decode(ids, skip_special_tokens))
        self.ids_of[text.strip()] = [int(i) for i in ids]
        return text


def divergence_gap(chat, cfg, question: str, a: list, b: list,
                   stop: int) -> tuple:
    """Where greedy token lists ``a`` (the dense route's) and ``b`` first
    differ, the dense path's logits teacher-forced on their common prefix:
    (position, max logit - logit of b's token, max |logit|). A list that
    ends first ends with ``stop``."""
    p = next(i for i in range(max(len(a), len(b)) + 1)
             if i >= len(a) or i >= len(b) or a[i] != b[i])
    theirs = b[p] if p < len(b) else stop
    ids, pos, _ = chat.encode_chat(question, [])
    row = first_logits(chat, cfg, ids, pos, np.zeros((1, 3, 448, 448),
                                                     np.float32),
                       a[:p], "dense", steps=p)[p]
    return p, (row.max() - row[theirs]).item(), row.abs().max().item()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def run_eval_route(argv: list, tok) -> tuple:
    """``evalkit.cli.main(argv, tokenizer=tok)`` with the launch counts
    zeroed just before it: (counts, seconds of its answering loop, the
    printed scores)."""
    import io
    import logging

    from v2pe_tpu_torch.evalkit import cli as eval_cli
    from v2pe_tpu_torch.evalkit import runner

    spent, run_shard = [], runner.run_shard

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run_shard(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return n

    torch.cuda.synchronize()
    reset_launches()
    runner.run_shard = timed
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            eval_cli.main(argv, tokenizer=tok)
    finally:
        runner.run_shard = run_shard
        logging.getLogger().setLevel(logging.WARNING)  # main() set INFO
    counts = read_launches()
    torch.cuda.empty_cache()
    return counts, spent[0], json.loads(printed.getvalue())


def phase_checkpoint_eval(model, cfg, tok, device: str = "cuda") -> list:
    """The full-width model exported as an HF safetensors directory (bf16,
    ``cfg.to_json()`` as config.json), loaded back onto the card (every
    tensor and the 8-tile request's first logits equal bit for bit), then
    the eval CLI's MM-NIAH route over made-up needle items of 1k-16k
    tokens, three times: dense, ``--engine-rows``, ``--weights-dtype int8``.
    Returns each route's launch counts."""
    import shutil
    import tempfile

    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.models.export import (export_torch_state_dict,
                                              save_safetensors)
    from v2pe_tpu_torch.models.params import load_safetensors_checkpoint

    tmp = tempfile.mkdtemp(prefix="v2pe_eval_")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt)
        path = os.path.join(ckpt, "model.safetensors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd = export_torch_state_dict(model, cfg)
        save_safetensors(sd, path, "bfloat16")
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            f.write(cfg.to_json())
        t_export = time.perf_counter() - t0
        n_tensors, size = len(sd), os.path.getsize(path)
        del sd
        t0 = time.perf_counter()
        loaded = load_safetensors_checkpoint(ckpt, cfg, device=device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        src, back = model.state_dict(), loaded.state_dict()
        differ = sorted(k for k in set(src) | set(back) if k not in back
                        or k not in src or not same_bits(src[k], back[k]))
        n, q = REQUESTS[0]
        chat = ChatModel(model, cfg, tok)
        ids, pos, _ = chat.encode_chat(q, [n])
        pixels = _tiles(n, 0)
        want = first_logits(chat, cfg, ids, pos, pixels, [], "dense", steps=0)
        got = first_logits(ChatModel(loaded, cfg, tok), cfg, ids, pos, pixels,
                           [], "dense", steps=0)
        del loaded, back, chat
        torch.cuda.empty_cache()
        log(f"checkpoint: exported {n_tensors} tensors, {size / 1e9:.3f} GB "
            f"bf16, in {t_export:.2f}s = {size / 1e9 / t_export:.2f} GB/s; "
            f"loaded onto the card in {t_load:.2f}s = "
            f"{size / 1e9 / t_load:.2f} GB/s; tensors equal bit for bit "
            f"{len(src) - len(differ)}/{len(src)}; the 8-tile request's "
            f"first logits equal bit for bit {same_bits(want, got)} "
            f"({card_line()})")
        if differ or not same_bits(want, got):
            raise AssertionError(f"the reloaded checkpoint differs: "
                                 f"{differ[:4]}")

        items = needle_items()
        data = os.path.join(tmp, "niah.jsonl")
        with open(data, "w") as f:
            for it in items:
                f.write(json.dumps(it) + "\n")
        routes = {
            "dense": [],
            "engine": ["--engine-rows", str(EVAL_ROWS),
                       "--engine-max-len", str(EVAL_MAX_LEN)],
            "int8": ["--weights-dtype", "int8"]}
        need = {"dense": ("flash_fwd",),
                "engine": ("flash_fwd", "paged_prefill"),
                "int8": ("flash_fwd", "qdot", "qdot_stacked")}
        answers, tokens, paths = {}, {}, []
        for name, extra in routes.items():
            out = os.path.join(tmp, name)
            rec = RecordingTokenizer()
            counts, secs, scores = run_eval_route(
                ["--benchmark", "mm_niah", "--checkpoint", ckpt,
                 "--config-preset", "internvl2_2b", "--tokenizer",
                 "code-point", "--data", data, "--outputs-dir", out,
                 "--task", EVAL_TASK, "--max-new-tokens", str(MAX_NEW),
                 "--platform", device, *extra], rec)
            with open(os.path.join(out, f"model_{EVAL_TASK}.jsonl")) as f:
                recs = {r["id"]: r["response"] for r in map(json.loads, f)}
            answers[name] = recs
            tokens[name] = {i: rec.ids_of[r] for i, r in recs.items()}
            generated = sum(len(tok(r)["input_ids"]) - 1
                            for r in recs.values())
            per_item = {k: round(v / len(items), 1) for k, v in
                        counts.items() if v}
            log(f"eval ({name}): {len(recs)}/{len(items)} items answered in "
                f"{secs:.3f}s = {len(recs) / secs:.3f} items/s, "
                f"{generated} response tokens = {generated / secs:.1f} "
                f"tok/s; MM-NIAH weighted accuracy "
                f"{scores['weighted_avg_acc']}; launches an item {per_item} "
                f"({card_line()})")
            if len(recs) != len(items):
                raise AssertionError(f"eval ({name}): {len(recs)} of "
                                     f"{len(items)} items answered")
            require(counts, need[name], f"eval ({name})")
            if name == "engine":
                require_riding_store(counts, "eval (engine)")
            paths.append(counts)
        # bf16 through 24 layers: the engine's chunked prefill and paged
        # decode are not the dense route's sums, so a greedy choice may go
        # the other way where the dense route's two best logits lie within
        # the distance of two bf16 paths (LOGIT_TOL), and only there
        same = [i for i in answers["dense"]
                if answers["engine"][i] == answers["dense"][i]]
        same8 = [i for i in answers["dense"]
                 if answers["int8"][i] == answers["dense"][i]]
        chat = ChatModel(model, cfg, tok)
        stop = chat.conv_template.stop_token_ids[0]
        gaps = {i: divergence_gap(chat, cfg, items[i]["context"]
                                  + items[i]["question"], tokens["dense"][i],
                                  tokens["engine"][i], stop)
                for i in answers["dense"] if i not in same}
        log(f"eval: engine responses equal to dense {len(same)}/{len(items)}"
            f" (the others first differ at token, dense logit gap to the "
            f"engine's token, max |logit|: {gaps}; limit {LOGIT_TOL} of max "
            f"|logit|), int8 {len(same8)}/{len(items)}")
        far = {i: g for i, g in gaps.items() if g[1] > LOGIT_TOL * g[2]}
        if far:
            raise AssertionError(f"eval: the engine route chose a token "
                                 f"beyond a near tie of the dense route's: "
                                 f"{far}")
        paths.append(tool_inference_test(ckpt, tmp, tok))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


def tool_inference_test(ckpt: str, tmp: str, tok) -> dict:
    """``python -m v2pe_tpu_torch.tools.inference_test`` on the exported
    checkpoint (its default platform, the card): a 900 x 600 image made
    here, tiled and asked about; the answer greedy. Returns its
    launches."""
    from PIL import Image

    from v2pe_tpu_torch.tools import inference_test

    image = os.path.join(tmp, "image.png")
    Image.fromarray(np.random.default_rng(5).integers(
        0, 255, (600, 900, 3), dtype=np.uint8)).save(image)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        answer = inference_test.main(
            ["--checkpoint", ckpt, "--tokenizer", "code-point", "--image",
             image, "--max-new-tokens", str(MAX_NEW)], tokenizer=tok)
    counts = read_launches()
    secs = time.perf_counter() - t0
    tiling = printed.getvalue().splitlines()[0]
    log(f"tools.inference_test: {tiling}; {len(answer)} characters answered "
        f"in {secs:.2f}s (the checkpoint loaded, bf16, on the card); "
        f"launches {dict((k, v) for k, v in counts.items() if v)}")
    require(counts, ("flash_fwd",), "tools.inference_test")
    return counts


# ------------------------------------------------ phase 2c: flash backward


BWD_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}  # max|kernel -
# twin| / max|twin| of each of dq, dk, dv; the twin computes in fp32
BWD_SAME_TOL = 2.0 ** -8  # the bf16 kernels against the twin on the same
# bf16 inputs with the same rounding points (p to bf16 for dV, ds for dK and
# dQ), taken before the twin's last rounding: both multiply the same bf16
# operands and differ by the order of the fp32 sums (where that moves a p or
# ds across a bf16 rounding boundary, one term of a sum of many moves by a
# bf16 step: ~1e-5 of the range), then the kernel rounds its output once to
# bf16, by at most half a bf16 step, which is below 2^-8 of the range
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
    return forms + compress_forms(randn, packed, device)


def bwd_kernel_ms(full, kw) -> dict:
    """Device time of each backward kernel alone on ``full`` = (q, k, v,
    ids..., out, lse, do), in ms (``time_ms``: CUDA events around calls
    queued behind a spin): the launches the wrapper makes, on q and k
    rotated as it rotates them. Timed one kernel at a time, since one
    wrapper call launches both."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    full, kw = list(full), dict(kw)
    theta = kw.pop("rope_theta", 0.0)
    rope_q, rope_k = kw.pop("rope_q", None), kw.pop("rope_k", None)
    if theta:
        full[0], full[1] = flash_fwd._apply_rope(full[0], full[1], rope_q,
                                                 rope_k, theta)
    *_, launches = flash_bwd._bwd_launches(*full, **kw)
    return {name: time_ms(launch, iters=3) for name, launch in launches}


def _grad_rel(a, b) -> float:
    """max|a - b| / max|b| (0 where both are 0: a form where nothing
    attends has zero gradients)."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def check_bwd(full, kw, got) -> tuple:
    """The backward kernels' (dq, dk, dv) ``got`` on ``full`` = (q, k, v,
    ids..., out, lse, do) against the twin: on fp32 copies of the inputs
    (BWD_TOL, the Pallas kernels' fp32 arithmetic) and, for bf16 inputs,
    on the same bf16 inputs with the kernels' rounding points
    (BWD_SAME_TOL): there the kernels run again on q and k rotated as the
    wrapper rotates them, so that only the kernels' arithmetic is held.
    Returns the text, whether every error is within its limit, the largest
    absolute error on fp32 copies, and the largest relative one."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    up = lambda ts: [t.float() if t.is_floating_point() else t for t in ts]
    want = flash_bwd.flash_attention_bwd_torch(*up(full), **kw)
    rels = [_grad_rel(a, b) for a, b in zip(got, want)]
    errs = [(a.float() - b).abs().max().item() for a, b in zip(got, want)]
    tol = BWD_TOL[full[0].dtype]
    ok = all(bool(torch.isfinite(t).all()) for t in got) and max(rels) <= tol
    text = (f"max|d-twin|/max|twin| dq {rels[0]:.3e} dk {rels[1]:.3e} dv "
            f"{rels[2]:.3e} (tol {tol:.3e})")
    del want
    if full[0].dtype == torch.bfloat16:
        full, kw = list(full), dict(kw)
        theta = kw.pop("rope_theta", 0.0)
        rope_q, rope_k = kw.pop("rope_q", None), kw.pop("rope_k", None)
        if theta:
            full[0], full[1] = flash_fwd._apply_rope(full[0], full[1],
                                                     rope_q, rope_k, theta)
        same = [_grad_rel(a, b) for a, b in zip(
            flash_bwd.flash_attention_bwd(*full, **kw),
            flash_bwd.flash_attention_bwd_torch(
                *up(full), rounding=torch.bfloat16, **kw))]
        ok = ok and max(same) <= BWD_SAME_TOL
        text += (f"; same bf16 inputs dq {same[0]:.3e} dk {same[1]:.3e} dv "
                 f"{same[2]:.3e} (tol {BWD_SAME_TOL:.3e})")
        rels += same
    return text, ok, max(errs), max(rels)


def sdpa_backward_ms(q, k, v, do, causal: bool, scale: float):
    """The library's backward of the same attention (dq, dk and dv in one
    call, so it stands beside both kernels): the forward runs once, outside
    the timing."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    try:
        out = sdpa(*leaves, causal, scale)
    except RuntimeError as e:  # the record only: nothing on the path calls it
        log(f"    library call refused: {e}")
        return None
    return library_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), iters=3)


def phase_bwd_kernels(packed: dict, device: str = "cuda") -> dict:
    """dkv and dq against the twin at every backward form; out and lse come
    from the forward kernel. Returns per-kernel lists of form records: each
    kernel's device time, and the twin's time for the whole backward. dkv
    runs four products per attended pair (scores, dP, dV, dK), dq three;
    each reads q, k, v, do, lse and di and writes its gradients. The main
    form is the ViT's, the one a library call expresses."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    records = {n: [] for n in BWD_KERNELS}
    for name, args, kw in bwd_forms(torch.device(device), packed):
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        do = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)
                         ).to(out)
        full = (*args, out, lse, do)
        got = flash_bwd.flash_attention_bwd(*full, **kw)
        torch.cuda.synchronize()
        text, ok, err, rel = check_bwd(full, kw, got)
        ms = time_ms(lambda: flash_bwd.flash_attention_bwd(*full, **kw),
                     iters=3)
        split = bwd_kernel_ms(full, kw)
        plain_ms = time_ms(
            lambda: flash_bwd.flash_attention_bwd_torch(*full, **kw), iters=3)
        q, k, v, seg_q, seg_k, pos_q, pos_k = args
        pairs = attended_pairs(seg_q, seg_k, pos_q, pos_k, kw["causal"])
        di = lse  # (B, Hq, Sq) fp32, like lse
        bounds = {
            "flash_bwd_dkv": attention_roof(q, k, v, pairs, 4, do, lse, di,
                                            got[1], got[2]),
            "flash_bwd_dq": attention_roof(q, k, v, pairs, 3, do, lse, di,
                                           got[0])}
        lib = sdpa_backward_ms(q, k, v, do, kw["causal"], kw["scale"]) \
            if name.startswith(("vit_tiles", "interaction")) \
            and device == "cuda" else None
        if name.startswith("llm_packed") and device == "cuda":
            # a yardstick only: the library cannot mask segments, so it
            # runs the whole row as one causal sequence (more pairs)
            one = sdpa_backward_ms(q, k, v, do, True, kw["scale"])
            log(f"    the backward of scaled_dot_product_attention on the "
                f"same shapes as one causal sequence: "
                f"{'none' if one is None else f'{one:.3f} ms'}")
        log(f"kernel bwd {name}: {text}; dkv "
            f"{split['flash_bwd_dkv']:.3f} ms + dq "
            f"{split['flash_bwd_dq']:.3f} ms on the device, wrapper "
            f"{ms:.3f} ms, twin {plain_ms:.3f} ms; bound dkv "
            f"{bounds['flash_bwd_dkv']['bound_ms']:.4f} ms + dq "
            f"{bounds['flash_bwd_dq']['bound_ms']:.4f} ms by "
            f"{bounds['flash_bwd_dq']['bound_by']}; library (the backward "
            f"of scaled_dot_product_attention, dq, dk and dv together) "
            f"{'none' if lib is None else f'{lib:.3f} ms'}")
        if not ok:
            raise AssertionError(f"flash backward disagrees with twin at "
                                 f"{name}")
        for n in BWD_KERNELS:
            records[n].append(dict(form=name, max_abs_err=err,
                                   max_rel_err=rel,
                                   ms=split[n],
                                   plain_ms=plain_ms, **bounds[n],
                                   library_ms=lib,
                                   main=name.startswith("vit_tiles")))
        del got, full
    torch.cuda.empty_cache()
    return records


def rank_forms(device, packed: dict):
    """(name, args, kwargs) of the flash kernels at the shapes one rank of
    a training mesh gives them (``parallel/mesh.py``, ``parallel/ring.py``):
    under tensor = 2 the ViT's 8 of 16 heads on 8 tiles and the LLM's 8/4
    of 16/8 heads on the packed 8192 tokens (q rotated in the kernel, as a
    rank's decoder calls it); under seq = 2 across ranks the rectangles the
    scan ring cuts from the zigzag shards of that row, each rank's
    (queries, chunk) pair with work (q and k rotated before the ring);
    under tensor = 2 compress-seq's interaction and within-chunk attention
    at 8/4 of the 16/8 heads."""
    from v2pe_tpu_torch.parallel import ring
    from v2pe_tpu_torch.train.synth import zigzag_permutation

    g = torch.Generator(device="cpu").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(device=device,
                                                    dtype=torch.bfloat16)

    def arange(B, S):
        return torch.arange(S, dtype=torch.int32,
                            device=device).expand(B, S).contiguous()

    ones = torch.ones(8, 1025, dtype=torch.int32, device=device)
    forms = [("rank_tensor2_vit_8x1025_8x64_bf16", (
        randn(8, 1025, 8, 64), randn(8, 1025, 8, 64), randn(8, 1025, 8, 64),
        ones, ones, arange(8, 1025), arange(8, 1025)),
        dict(causal=False, scale=64 ** -0.5))]
    seg = packed["segment_ids"].to(device).clone()
    S = seg.shape[1]
    seg[:, S - 200:] = 0
    forms.append((f"rank_tensor2_llm_packed_{S}_8_4x128_qrope_bf16", (
        randn(1, S, 8, 128), randn(1, S, 4, 128), randn(1, S, 4, 128), seg,
        seg, arange(1, S), arange(1, S)),
        dict(causal=True, scale=128 ** -0.5,
             rope_q=packed["rope_pos_ids"].to(device), rope_theta=1e6)))
    perm = torch.as_tensor(zigzag_permutation(S, 2), device=device)
    seg_z = seg[:, perm].contiguous()
    pos_z = perm.to(torch.int32)[None].contiguous()
    q, k, v = randn(1, S, 16, 128), randn(1, S, 8, 128), randn(1, S, 8, 128)
    table = ring.branch_table(ring.RingStatics(True, 1.0), 2, seg_z, seg_z,
                              pos_z, pos_z).tolist()
    half = S // 2
    for r, c in itertools.product(range(2), range(2)):
        rect = ring._rectangle(table[r][c], r, c, half)
        if rect is None:
            continue
        qr, kr = rect
        forms.append((
            f"rank_seq2_zigzag_{S}_r{r}_chunk{c}_q{qr.stop - qr.start}_"
            f"k{kr.stop - kr.start}_bf16",
            tuple(t[:, rows].contiguous() for t, rows in (
                (q, qr), (k, kr), (v, kr), (seg_z, qr), (seg_z, kr),
                (pos_z, qr), (pos_z, kr))),
            dict(causal=True, scale=128 ** -0.5)))
    # compress-seq under tensor = 2 (PR 16): the interaction over the 4 x
    # 100 summaries and the within-chunk attention at a rank's 8/4 heads
    for name, args, kw in compress_forms(randn, packed, device):
        if name.endswith("bf16"):
            forms.append((f"rank_tensor2_{name[:-5]}_8_4x128_bf16", (
                args[0][:, :, :8].contiguous(), args[1][:, :, :4].contiguous(),
                args[2][:, :, :4].contiguous(), *args[3:]), kw))
    return forms


def phase_rank_forms(packed: dict, device: str = "cuda") -> dict:
    """#1-#3 against their plain versions at the per-rank forms
    (``rank_forms``), the kernels' outputs allocated full of NaN
    (``nan_empty``): the forward's out and lse at TOL, the backward's
    gradients at BWD_TOL / BWD_SAME_TOL; each with its device time, the
    plain version's and the bound. Returns per-kernel form records (none
    is a kernel's main form)."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    records = {"flash_fwd": [], **{n: [] for n in BWD_KERNELS}}
    for name, args, kw in rank_forms(torch.device(device), packed):
        with nan_empty():
            out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
            do = torch.randn(out.shape, generator=torch.Generator(
            ).manual_seed(4)).to(out)
            full = (*args, out, lse, do)
            got = flash_bwd.flash_attention_bwd(*full, **kw)
            torch.cuda.synchronize()
        text, err = check_flash(name, args, kw, out, lse)
        btext, ok, berr, brel = check_bwd(full, kw, got)
        if not ok:
            raise AssertionError(f"flash backward disagrees with twin at "
                                 f"{name}: {btext}")
        q, k, v, seg_q, seg_k, pos_q, pos_k = args
        pairs = attended_pairs(seg_q, seg_k, pos_q, pos_k, kw["causal"])
        ms = time_ms(lambda: flash_fwd.flash_attention_fwd(*args, **kw))
        plain_ms = time_ms(
            lambda: flash_fwd.flash_attention_fwd_torch(*args, **kw))
        bound = attention_roof(q, k, v, pairs, 2, out, lse)
        split = bwd_kernel_ms(full, kw)
        bplain = time_ms(
            lambda: flash_bwd.flash_attention_bwd_torch(*full, **kw), iters=3)
        bounds = {
            "flash_bwd_dkv": attention_roof(q, k, v, pairs, 4, do, lse, lse,
                                            got[1], got[2]),
            "flash_bwd_dq": attention_roof(q, k, v, pairs, 3, do, lse, lse,
                                           got[0])}
        log(f"kernel {name}: {text}; bwd {btext}; fwd {ms:.3f} ms (twin "
            f"{plain_ms:.3f}, bound {bound['bound_ms']:.4f} by "
            f"{bound['bound_by']}), dkv {split['flash_bwd_dkv']:.3f} "
            f"+ dq {split['flash_bwd_dq']:.3f} ms on the device (twin "
            f"{bplain:.3f}, bound {bounds['flash_bwd_dkv']['bound_ms']:.4f} "
            f"+ {bounds['flash_bwd_dq']['bound_ms']:.4f}); outputs into NaN")
        records["flash_fwd"].append(dict(
            form=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound,
            library_ms=None, main=False))
        for n in BWD_KERNELS:
            records[n].append(dict(form=name, max_abs_err=berr,
                                   max_rel_err=brel, ms=split[n],
                                   plain_ms=bplain, **bounds[n],
                                   library_ms=None, main=False))
        del got, full
    torch.cuda.empty_cache()
    return records


BWD_SWEEP_FORMS = 24  # seeded random forms of the flash backward


def bwd_sweep_form(rng, device):
    """(name, args, kwargs) of one random form of the flash backward: head
    dim 64 or 128, GQA ratio 1, 2 or 4; positions in order, or zigzag as the
    ring cuts them (a rank's two chunks of 2 W chunks, or one of them, for
    queries and keys of two ranks: Sq and Sk may differ); 1-3 segments cut
    at random with a ragged padded tail, at times a batch row of padding;
    causal or not; bf16 or fp32."""
    D, G = int(rng.choice([64, 128])), int(rng.choice([1, 2, 4]))
    Hkv, B = int(rng.integers(1, 3)), int(rng.integers(1, 3))
    causal, dtype = bool(rng.integers(2)), \
        [torch.bfloat16, torch.float32][int(rng.integers(2))]
    zigzag = rng.random() < 0.5
    if zigzag:  # a rectangle of a ring of W ranks over 2 W chunks of c
        W, c = int(rng.integers(2, 5)), int(rng.integers(20, 200))
        chunks = np.arange(2 * W * c).reshape(2 * W, c)

        def rank_rows(half):
            r = int(rng.integers(W))
            two = [chunks[r], chunks[2 * W - 1 - r]]
            return two[half] if half is not None else np.concatenate(two)

        pick = lambda: [None, 0, 1][int(rng.integers(3))]
        pq, pk = rank_rows(pick()), rank_rows(pick())
        Sq, Sk = len(pq), len(pk)
        pos_q, pos_k = (np.broadcast_to(p, (B, len(p))).copy()
                        for p in (pq, pk))
    else:
        Sq = int(rng.integers(1, 600))
        Sk = Sq if rng.random() < 0.5 else int(rng.integers(1, 700))
        pos_q = np.broadcast_to(np.arange(Sq) + max(Sk - Sq, 0),
                                (B, Sq)).copy()
        pos_k = np.broadcast_to(np.arange(Sk), (B, Sk)).copy()

    # 1-3 segments cut at the same positions for queries and keys
    cuts = np.sort(rng.integers(0, max(pos_q.max(), pos_k.max()) + 2,
                                int(rng.integers(0, 3))))

    def segments(pos):
        seg = (np.searchsorted(cuts, pos, side="right") + 1).astype(np.int32)
        S = pos.shape[1]
        seg[:, S - int(rng.integers(0, max(S // 4, 1))):] = 0  # ragged tail
        return seg

    seg_q = segments(pos_q)
    seg_k = segments(pos_k)
    if B > 1 and rng.random() < 0.5:
        seg_q[int(rng.integers(B))] = 0  # a row of padding
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, dtype)
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
        device)
    args = (x(B, Sq, Hkv * G, D), x(B, Sk, Hkv, D), x(B, Sk, Hkv, D),
            i32(seg_q), i32(seg_k), i32(pos_q), i32(pos_k))
    name = (f"B{B}_{Sq}x{Sk}_{Hkv * G}/{Hkv}x{D}_"
            f"{'causal' if causal else 'bidir'}_"
            f"{'zigzag' if zigzag else 'ordered'}_"
            f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}")
    return name, args, dict(causal=causal, scale=D ** -0.5)


def phase_bwd_sweep(device: str = "cuda") -> dict:
    """The two backward kernels at BWD_SWEEP_FORMS seeded random forms
    (bwd_sweep_form), out and lse from the forward kernel, each held as
    phase_bwd_kernels holds its forms (check_bwd); one line with the count
    and the largest errors. Returns form records per kernel."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    records = {n: [] for n in BWD_KERNELS}
    worst = {torch.bfloat16: (0.0, ""), torch.float32: (0.0, "")}
    for _ in range(BWD_SWEEP_FORMS):
        name, args, kw = bwd_sweep_form(rng, device)
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        do = torch.from_numpy(rng.standard_normal(out.shape).astype(
            np.float32)).to(out)
        full = (*args, out, lse, do)
        text, ok, err, rel = check_bwd(
            full, kw, flash_bwd.flash_attention_bwd(*full, **kw))
        if not ok:
            raise AssertionError(f"flash backward disagrees with twin at "
                                 f"sweep {name}: {text}")
        worst[args[0].dtype] = max(worst[args[0].dtype], (rel, name))
        for n in BWD_KERNELS:
            records[n].append(dict(form=f"sweep_{name}", max_abs_err=err,
                                   main=False))
    log(f"kernel bwd sweep: {BWD_SWEEP_FORMS} seeded random forms within "
        f"their limits; largest relative error bf16 "
        f"{worst[torch.bfloat16][0]:.3e} at {worst[torch.bfloat16][1]}, "
        f"fp32 {worst[torch.float32][0]:.3e} at "
        f"{worst[torch.float32][1]}; {time.perf_counter() - t0:.1f} s")
    return records


# ---------------------------------------------- phase 2d: quantized products


QDOT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}  # max |kernel -
# plain| / max |plain| by the output's dtype: both multiply the same
# bf16-exact operands and sum in fp32 in another order (1e-5); a bf16
# output may then round to the neighbouring value (one step, 2^-8 of it)
QDOT_KERNELS = ("qdot", "qdot_stacked", "q4dot", "q4dot_stacked")


@contextlib.contextmanager
def nan_empty():
    """While active, ``torch.empty`` and ``torch.empty_like`` fill floating
    tensors with NaN: an output element that a kernel leaves unwritten then
    fails a check, instead of holding what an earlier call left in the
    caching allocator's block."""
    empty, empty_like = torch.empty, torch.empty_like

    def poison(alloc):
        def poisoned(*args, **kwargs):
            t = alloc(*args, **kwargs)
            return t.fill_(float("nan")) if t.is_floating_point() else t
        return poisoned

    torch.empty, torch.empty_like = poison(empty), poison(empty_like)
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


PREFILL_ROWS = 2167  # the 8-tile request's prompt
SESSION_CHUNK = 2048  # a session's (and the engine's) prefill chunk
PREFILL_TAIL = PREFILL_ROWS - SESSION_CHUNK  # the prompt's last chunk


def _random_weight(bits: int, shape, g, device):
    """A quantized weight of random codes and scales (stacked when shape has
    a leading L), in the layouts ``quantize_weight*`` produce."""
    from v2pe_tpu_torch.ops import quantized_matmul as qm

    w = qm.empty_weight(bits, shape, device=device)
    if bits == 8:
        w.q.copy_(torch.randint(-127, 128, w.q.shape, generator=g,
                                device=device, dtype=torch.int8))
    else:  # two codes in [-7, 7] a byte
        lo, hi = (torch.randint(-7, 8, w.p.shape, generator=g, device=device,
                                dtype=torch.int32) for _ in range(2))
        w.p.copy_(((lo & 0xF) | (hi << 4)).to(torch.int8))
    w.scale.copy_(torch.rand(w.scale.shape, generator=g, device=device)
                  * 4e-4 + 1e-4)
    return w


def quant_forms(cfg):
    """(kernel, name, weight shape, M, x dtype, out dtype) of every form the
    quantized serving path launches: the vocab head at M = 3 and 1 (fp32
    logits), each of the five layer products at M = 3 (decode), and wqkv
    and w2 at the 8-tile request's prefill rows, x in bf16 (the served
    model) and fp32; then, x bf16, the five layer products at M = 1, and
    wqkv and w2 at the kernels' body switch (M = 16, 17), at a session's
    2048-token chunk and at the 8-tile prompt's last 119 rows; int8 then
    int4."""
    lc = cfg.llm
    D, I, L, V = lc.hidden_size, lc.intermediate_size, \
        lc.num_hidden_layers, lc.vocab_size
    Hd = lc.num_attention_heads * lc.head_dim
    layer = {"wqkv": (D, Hd + 2 * lc.num_key_value_heads * lc.head_dim),
             "wo": (Hd, D), "w1": (D, I), "w3": (D, I), "w2": (I, D)}
    forms = []
    for bits, k2d, kst in ((8, "qdot", "qdot_stacked"),
                           (4, "q4dot", "q4dot_stacked")):
        for xdt in (torch.bfloat16, torch.float32):
            tag = "bf16" if xdt == torch.bfloat16 else "fp32"
            for M in (3, 1):
                forms.append((k2d, f"head_M{M}_{tag}", bits, (D, V), M, xdt,
                              torch.float32))
            for name, shape in layer.items():
                forms.append((kst, f"{name}_M3_{tag}", bits, (L, *shape), 3,
                              xdt, xdt))
            for name in ("wqkv", "w2"):
                forms.append((kst, f"{name}_M{PREFILL_ROWS}_{tag}", bits,
                              (L, *layer[name]), PREFILL_ROWS, xdt, xdt))
        bf = torch.bfloat16
        for name, shape in layer.items():
            forms.append((kst, f"{name}_M1_bf16", bits, (L, *shape), 1, bf,
                          bf))
        for name in ("wqkv", "w2"):
            for M in (16, 17, SESSION_CHUNK, PREFILL_TAIL):
                forms.append((kst, f"{name}_M{M}_bf16", bits,
                              (L, *layer[name]), M, bf, bf))
    return forms


QUANT_SWEEP_FORMS = 24  # seeded random forms of the four quantized products


def quant_sweep_form(rng, device):
    """One random quantized product: int8 or int4, a 2-D weight (qdot,
    q4dot) or a stack of 1-3 layers read at a random layer; M from 1 to
    2200 (half of the forms at M <= 16, the strip body); D from 40 to full
    width (small D shrinks int4's group: D = 352 gives gs 16, D = 40 gs 4);
    N from 1 to 9000 (padded to 128); bf16 or fp32 x and out. Returns
    (kernel, name, weight, x, li, out dtype)."""
    bits = int(rng.choice([8, 4]))
    stacked = bool(rng.random() < 0.75)
    M = int(rng.integers(1, 17) if rng.random() < 0.5
            else rng.integers(17, 2201))
    D = int(rng.choice([40, 96, 256, 352, 1000, 2048, 4096, 8192]))
    N = int(rng.integers(1, 9001))
    L = int(rng.integers(1, 4)) if stacked else 0
    xdt, odt = (torch.bfloat16 if rng.random() < 0.6 else torch.float32
                for _ in range(2))
    g = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 30)))
    shape = (L, D, N) if stacked else (D, N)
    w = _random_weight(bits, shape, g, device)
    x = torch.randn((M, D), generator=g, device=device).to(xdt)
    li = int(rng.integers(0, L)) if stacked else None
    kernel = ("q4dot" if bits == 4 else "qdot") + ("_stacked" * stacked)
    name = (f"M{M}_D{D}_N{N}_L{L}_li{li}_x{str(xdt)[6:]}_"
            f"out{str(odt)[6:]}")
    return kernel, name, w, x, li, odt


def phase_quant_sweep(device: str = "cuda") -> dict:
    """QUANT_SWEEP_FORMS seeded random forms of the four quantized products
    against their plain versions (QDOT_TOL) and run twice (bitwise equal);
    each with kernel, bound, plain and F.linear times."""
    import torch.nn.functional as F

    from v2pe_tpu_torch.ops import quantized_matmul as qm

    t0 = time.perf_counter()
    rng = np.random.default_rng(29)
    records = {n: [] for n in QDOT_KERNELS}
    worst = 0.0
    for _ in range(QUANT_SWEEP_FORMS):
        kernel, name, w, x, li, odt = quant_sweep_form(rng, device)
        if li is None:
            run = lambda: qm.quantized_dot(x, w, odt)
            plain = lambda: qm.quantized_dot_torch(x, w, odt)
        else:
            run = lambda: qm.quantized_dot_stacked(x, w, li, odt)
            plain = lambda: qm.quantized_dot_stacked_torch(x, w, li, odt)
        with nan_empty():
            got, again = run(), run()
        want = plain().float()
        err = (got.float() - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        same = bool(torch.equal(got, again))
        dense = torch.randn(w.n_out, x.shape[1], device=device).to(
            torch.bfloat16)
        xb = x.to(torch.bfloat16)
        n = 3 if x.shape[0] > 16 else 10
        ms, plain_ms, lib = (time_ms(f, iters=n) for f in (
            run, plain, lambda: F.linear(xb, dense)))
        layers = w.payload.shape[0] if li is not None else 1
        bound = roof(nbytes(w.payload, w.scale) // layers + nbytes(x, got),
                     2.0 * x.shape[0] * x.shape[1] * w.n_out)
        log(f"kernel sweep {kernel} {name}: max|kernel-plain| {err:.3e} = "
            f"{rel:.3e} of max|plain| (tol {QDOT_TOL[odt]:.1e}); repeat "
            f"bitwise equal {same}; kernel {ms:.4f} ms, bound "
            f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}, plain "
            f"{plain_ms:.3f} ms, F.linear {lib:.4f} ms")
        if not (got.shape == want.shape and got.dtype == odt and same
                and bool(torch.isfinite(got).all())
                and rel <= QDOT_TOL[odt]):
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version (or with itself) at {name}")
        worst = max(worst, rel)
        records[kernel].append(dict(
            form=f"sweep_{name}", max_abs_err=err, max_rel_err=rel, ms=ms,
            plain_ms=plain_ms, **bound, library_ms=lib, main=False))
        del w, x, got, again, want, dense
    torch.cuda.empty_cache()
    log(f"kernel quant sweep: {QUANT_SWEEP_FORMS} forms within QDOT_TOL "
        f"(largest {worst:.3e} of the range), each bitwise repeatable; "
        f"{time.perf_counter() - t0:.1f} s")
    return records


def phase_quant_kernels(cfg, device: str = "cuda") -> dict:
    """Each quantized-product kernel against its plain version at every
    form, on random codes and scales. A stacked form reads another layer at
    every timed launch, so no launch finds its weights in the L2 cache (as
    in a decode step, which streams every layer once); the head exceeds the
    cache by itself. Beside each: the bound, and the time of ``F.linear`` on
    an unquantized bf16 weight of the same shape, which is the product the
    quantized one replaces, not the same function. Main forms: the head and
    w1 at M = 1, bf16."""
    import torch.nn.functional as F

    from v2pe_tpu_torch.ops import quantized_matmul as qm

    t0 = time.perf_counter()
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(17)
    records = {n: [] for n in QDOT_KERNELS}
    held = w = dense = None  # the weight in memory, and its bf16 counterpart
    for kernel, name, bits, shape, M, xdt, odt in quant_forms(cfg):
        *lead, D, N = shape
        if (bits, shape) != held:
            w = dense = None
            torch.cuda.empty_cache()
            w = _random_weight(bits, shape, g, dev)
            dense = torch.empty((*lead, N, D), dtype=torch.bfloat16,
                                device=dev).normal_(0, 0.02, generator=g)
            held = (bits, shape)
        x = torch.randn((M, D), generator=g, device=dev).to(xdt)
        layers = itertools.cycle(range(lead[0])) if lead \
            else itertools.repeat(None)

        def each_layer(call):
            """``call(li)`` on the next layer of the stack at every call."""
            return lambda: call(next(layers))

        if lead:
            run = lambda li: qm.quantized_dot_stacked(x, w, li, odt)
            plain = lambda li: qm.quantized_dot_stacked_torch(x, w, li, odt)
            linear = lambda li: F.linear(x.to(torch.bfloat16), dense[li])
        else:
            run = lambda li: qm.quantized_dot(x, w, odt)
            plain = lambda li: qm.quantized_dot_torch(x, w, odt)
            linear = lambda li: F.linear(x.to(torch.bfloat16), dense)
        li = lead[0] // 2 if lead else None
        before = qm.LAUNCHES[kernel]
        with nan_empty():
            got, again = run(li), run(li)
        torch.cuda.synchronize()
        if dev.type == "cuda" and qm.LAUNCHES[kernel] != before + 2:
            raise AssertionError(f"{name}: the wrapper did not launch "
                                 f"{kernel}")
        if not torch.equal(got, again):
            raise AssertionError(f"{kernel} at {name}: two launches on the "
                                 f"same inputs differ (or leave elements "
                                 f"unwritten)")
        want = plain(li).float()
        err = (got.float() - want).abs().max().item()
        rel = err / want.abs().max().item()
        tol = QDOT_TOL[odt]
        n = 3 if M > 16 else 24
        ms, plain_ms, lib = (time_ms(each_layer(f), iters=n)
                             for f in (run, plain, linear))
        # and as the host issues them: what a decode step pays a call
        wrapper_ms = time_ms(each_layer(run), iters=n, behind_spin=False)
        per_layer = lambda t: t.numel() * t.element_size() // (
            lead[0] if lead else 1)
        bound = roof(per_layer(w.payload) + per_layer(w.scale) + nbytes(x)
                     + got.numel() * got.element_size(), 2.0 * M * D * N)
        log(f"kernel {kernel} int{bits} {name}: max|kernel-plain| {err:.3e} "
            f"= {rel:.3e} of max|plain| (tol {tol:.3e}), two launches "
            f"bitwise equal; on the device: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound['bound_ms']:.5f} ms by {bound['bound_by']}, F.linear on "
            f"a bf16 weight of this shape (the product it replaces) "
            f"{lib:.4f} ms; wrapper calls back to back {wrapper_ms:.4f} ms")
        if not (got.shape == (M, N) and got.dtype == odt
                and bool(torch.isfinite(got).all()) and rel <= tol):
            raise AssertionError(f"{kernel} disagrees with its plain "
                                 f"version at {name}")
        records[kernel].append(dict(
            form=f"int{bits}_{name}", max_abs_err=err, max_rel_err=rel,
            ms=ms, plain_ms=plain_ms, wrapper_ms=wrapper_ms, **bound,
            library_ms=lib, main=name in ("head_M1_bf16", "w1_M1_bf16")))
        del got, again, want, x
    del w, dense
    torch.cuda.empty_cache()
    log(f"kernel quant forms: {len(quant_forms(cfg))} in "
        f"{time.perf_counter() - t0:.1f} s")
    return records


def _small_quant_logits(llm, lc, dev: str):
    """fp32 logits of a quantized 2-layer decoder on one device: a 40-token
    forward without a cache (the wgmma body), then over a dense cache a
    24-token prefill, four 1-token steps, a 3-token and a 9-token step (the
    strip body at 8 and at 16 rows)."""
    from v2pe_tpu_torch.models import internlm2

    m = llm.to(dev)
    ids = torch.as_tensor(np.random.default_rng(19).integers(3, 990, (1, 40)),
                          device=dev)
    with torch.inference_mode():
        out = [internlm2.llm_forward(m, lc, input_ids=ids)[0][0]]
        cache = internlm2.KVCache.zeros(lc, 1, 40, dtype=torch.float32,
                                        device=dev)
        for a, b in [(0, 24)] + [(t, t + 1) for t in range(24, 28)] \
                + [(28, 31), (31, 40)]:
            lg, cache = internlm2.llm_forward(m, lc, input_ids=ids[:, a:b],
                                              kv_cache=cache)
            out.append(lg[0])
    return torch.cat(out).cpu()


QUANT_LOGIT_TOL = 2e-3  # fp32 quantized model, card vs CPU, of the logits'
# range: x is rounded to bf16 before every product, so a sum whose last bit
# differs can land on the other side of a bf16 step one layer later


def phase_small_quant_reference(devices=("cpu", "cuda")) -> None:
    """A 2-layer fp32 decoder quantized to int8 and to int4 (w2's depth 352
    shrinks its int4 groups to 16): logits on the card (the kernels)
    against the CPU (the plain versions)."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.ops import quantized_matmul as qm

    cfg = config.VLMConfig(
        vision=config.VisionConfig(hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=1, num_attention_heads=2,
                                   image_size=112, patch_size=14),
        llm=config.LLMConfig(vocab_size=1000, hidden_size=256,
                             intermediate_size=352, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2))
    model = init_vlm_params(cfg, torch.Generator().manual_seed(23))
    for bits in (8, 4):
        qllm = qm.quantize_llm_params(model.llm, bits=bits)
        reset_launches()
        cpu, gpu = (_small_quant_logits(qllm, cfg.llm, d) for d in devices)
        counts = read_launches()
        qllm.to("cpu")
        d = _rel(gpu, cpu)
        names = ("qdot", "qdot_stacked") if bits == 8 else \
            ("q4dot", "q4dot_stacked")
        log(f"reference: small int{bits} decoder fp32, card vs CPU "
            f"max|dlogit|/max|logit| {d:.3e} over {cpu.shape[0]} positions "
            f"(tol {QUANT_LOGIT_TOL}); launches "
            f"{ {n: counts[n] for n in QDOT_KERNELS} }")
        require(counts, names, f"small int{bits} reference")
        if not d <= QUANT_LOGIT_TOL:
            raise AssertionError(f"card and CPU int{bits} decoders disagree")


# ------------------------------------------------- phase 11: quantized serve


def phase_quant_serve(model, cfg, tok, served: dict) -> list:
    """The three requests through ChatModel(weights_dtype=...): int8 and
    int4 weights over the dense cache, then int8 weights over the paged
    cache with an int8 pool (w8kv8). Each: launch counts (every forward 5
    stacked launches a layer and one head launch, none of the other width),
    TTFT and decode rate of the 8-tile request, stream equal to generate,
    and the first-token logits against the bf16 model's (reported; the
    quantization error through 24 random layers is real). Returns the
    launch counts of each path and the quantized models by width. The
    stream check runs on the paged path only (the dense ones ran it in
    bf16)."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    pixels = _request_pixels()
    tiles, _ = REQUESTS[0]
    ids, pos, pix = served["ids"], served["pos"], served["pixels"]
    L = cfg.llm.num_hidden_layers
    bf16 = first_logits(ChatModel(model, cfg, tok), cfg, ids, pos, pix, [],
                        "dense", steps=0)
    paths, quantized = [], {}
    for wd, mode, kv in (("int8", "dense", None), ("int4", "dense", None),
                         ("int8", "paged", "int8")):
        t0 = time.perf_counter()
        chat = ChatModel(quantized.get(wd, model), cfg, tok,
                         weights_dtype=wd, cache_mode=mode, kv_dtype=kv)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        quantized[wd] = chat.model
        llm = chat.model.llm
        held = sum(t.numel() * t.element_size() for w in
                   [*llm.stacks.values(), llm.output] for t in w.buffers())
        tag = f"w{wd[3:]}" + (f"kv{kv[3:]} paged" if kv else " dense")
        reset_launches()
        t0 = time.perf_counter()
        answers = chat.batch_chat(pixels, [q for _, q in REQUESTS], gc)
        counts = read_launches()
        wall = time.perf_counter() - t0
        mine = ("qdot", "qdot_stacked") if wd == "int8" else \
            ("q4dot", "q4dot_stacked")
        head, stacked = counts[mine[0]], counts[mine[1]]
        other = sum(counts[n] for n in QDOT_KERNELS if n not in mine)
        log(f"quantized serve ({tag}): quantized in {t_quant:.2f}s to "
            f"{held / 2 ** 30:.3f} GiB of codes and scales; 3 requests in "
            f"{wall:.3f}s, {head} forwards: head launches {head}, stacked "
            f"{stacked} = {stacked // max(head, 1)} a forward, other width "
            f"{other}; answers {[len(a) for a in answers]} chars; launches "
            f"{counts}")
        if not (len(answers) == 3 and head >= 3 and stacked == 5 * L * head
                and other == 0):
            raise AssertionError(f"quantized serve ({tag}): expected "
                                 f"{5 * L} stacked launches and 1 head "
                                 f"launch a forward")
        require(counts, ("flash_fwd",), f"quantized serve ({tag})")
        if mode == "paged":
            require_riding_store(counts, f"quantized serve ({tag})")
        ttft, total, rate, tokens = time_request(
            chat, cfg, ids, pos, pix, served["gc"], cache_mode=mode,
            kv_dtype=kv)
        log(f"quantized serve ({tag}): prompt {len(ids)} tokens ({tiles} "
            f"tiles): TTFT {ttft * 1e3:.1f} ms, {len(tokens)} tokens in "
            f"{total * 1e3:.1f} ms, decode {rate:.1f} tok/s")
        if mode == "paged":
            phase_stream(chat, cfg, dict(served, tokens=tokens),
                         cache_mode=mode, kv_dtype=kv)
        mine_logits = first_logits(chat, cfg, ids, pos, pix, [], mode,
                                   kv_dtype=kv, steps=0)
        ok = bool(torch.isfinite(mine_logits).all())
        log(f"quantized serve ({tag}): first-token logits vs the bf16 "
            f"model's: max|dlogit|/max|logit| {_rel(mine_logits, bf16):.3e}"
            f" (reported, no limit), argmax equal "
            f"{torch.equal(mine_logits.argmax(-1), bf16.argmax(-1))}, "
            f"finite {ok}")
        if not ok:
            raise AssertionError(f"quantized serve ({tag}): logits not "
                                 f"finite")
        paths.append(counts)
    return paths, quantized


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


def small_train_batch(cfg, device, max_tokens: int = 300,
                      seq_shards: int = 1) -> dict:
    """Two samples (150 and 130 tokens, one 112-pixel tile each) packed
    into a 300-token row with a padded tail, as the trainer collates
    (zigzag-permuted for ``seq_shards`` ring shards)."""
    from v2pe_tpu_torch import packing

    rng = np.random.default_rng(13)
    nit = cfg.num_image_token
    rows = [[synthetic_sample(rng, n, 1, nit, 112, ids=(997, 998, 999),
                              vocab_hi=990, stride=2) for n in (150, 130)]]
    batch = packing.collate_rows(rows, max_tokens=max_tokens, max_tiles=2,
                                 img_context_token_id=999,
                                 num_image_token=nit, seq_shards=seq_shards)
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


def _step_hook(steps: list, marks: dict):
    """A trainer metrics hook that keeps each step's metrics and the
    launches since the previous step."""
    def hook(step, metrics):
        counts = read_launches()
        prev = marks.get("counts", {k: 0 for k in counts})
        steps.append(dict(metrics, launches={
            k: counts[k] - prev[k] for k in counts}))
        marks["counts"] = counts
        marks["t"] = time.perf_counter()

    return hook


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
    hook = _step_hook(steps, marks)
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


def timed_steps(where: str, step, model, state, batch, then=None) -> list:
    """BENCH_STEPS calls of a train step on one batch: per step its loss,
    grad norm, host ms (to the read of the loss) and launches, each
    logged. ``then(i)``: called after step i (from 1), outside the timing
    and the launch count."""
    steps = []
    for i in range(BENCH_STEPS):
        before = read_launches()
        t0 = time.perf_counter()
        loss, gnorm = step(model, state, batch)
        loss, gnorm = loss.item(), gnorm.item()
        ms = (time.perf_counter() - t0) * 1e3
        after = read_launches()
        steps.append(dict(loss=loss, grad_norm=gnorm, ms=ms, launches={
            k: after[k] - before[k] for k in after}))
        log(f"{where} step {i + 1}: loss {loss:.4f} grad_norm "
            f"{gnorm:.4f} {ms:.1f} ms {TRAIN_TOKENS / ms * 1e3:.0f} tok/s; "
            f"launches {steps[-1]['launches']}")
        if then is not None:
            then(i + 1)
    return steps


# the int8 states of two bf16 runs are compared after this step: the
# warmup makes step 1's update zero, so steps 1-2 take their gradients at
# the same weights in both runs; step 2's update then parts them (where a
# gradient is near 0, g / (|g| + eps) turns an ulp into a sign), and step
# 3's gradients with them
INT8_SAME_WEIGHTS_STEP = 2


def phase_bench_recipe(model, cfg, against=None, moments=None) -> dict:
    """Three steps of the bench recipe (make_train_step called directly,
    the first step bench.py's compile step): per-step loss, grad_norm,
    time and launches, and the median rate of steps 2-3. ``against``: the
    steps of ``phase_dist_train`` from the same weights, whose losses and
    grad norms must match these within RING_TRAIN_TOL; ``moments``: its
    int8 state gathered after them, which ``compare_int8`` holds to this
    run's."""
    step, state, batch = bench_recipe(model, cfg)
    model.train()
    reset_launches()
    held = {}
    steps = timed_steps("bench recipe", step, model, state, batch,
                        lambda i: held.update(int8_on_card(
                            model, state, f"bench recipe after step {i}",
                            to_cpu=False))
                        if moments is not None
                        and i == INT8_SAME_WEIGHTS_STEP else None)
    counts = read_launches()
    model.eval()
    ms = sorted(m["ms"] for m in steps[1:])[len(steps[1:]) // 2]
    log(f"bench recipe: make_train_step on make_synthetic_batch, "
        f"{TRAIN_TOKENS} tokens x {TRAIN_TILES} tiles in one segment "
        f"(remat full, int8 Adam): median of steps 2-{BENCH_STEPS} "
        f"{ms:.1f} ms = {TRAIN_TOKENS / ms * 1e3:.0f} tok/s")
    check_train_steps(cfg, steps, BENCH_STEPS, "bench recipe")
    if against is not None:
        rel = [(abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))
               for a, b in zip(against, steps)]
        log(f"dist train against the bench recipe, step by step: loss rel "
            f"{[f'{r[0]:.2e}' for r in rel]} (tol "
            f"{RING_TRAIN_TOL['loss']}), grad_norm rel "
            f"{[f'{r[1]:.2e}' for r in rel]} (tol "
            f"{RING_TRAIN_TOL['grad_norm']})")
        if len(rel) != BENCH_STEPS or any(
                r[0] > RING_TRAIN_TOL["loss"]
                or r[1] > RING_TRAIN_TOL["grad_norm"] for r in rel):
            raise AssertionError("the world-1 mesh's steps disagree with the "
                                 "single-process steps")
    if moments is not None:
        compare_int8(moments, held, f"dist train against the bench recipe "
                     f"after step {INT8_SAME_WEIGHTS_STEP}")
    return counts


def phase_dist_train(model, cfg, device: str = "cuda") -> tuple:
    """The training path of a mesh of processes, as a world of 1 over NCCL:
    the process group through ``parallel/bootstrap.py`` (a file store in a
    temporary directory), a copy of the model placed on the 1-wide mesh
    (``shard_model``: FSDP2 per decoder and ViT layer, DTensor parameters),
    and BENCH_STEPS steps of ``make_train_step(mesh=MeshConfig())`` on the
    bench recipe's batch (``make_global_batch``; the global CE denominator,
    the reduce-scatter and int8 Adam on the shards, its state gathered to
    one device's layout after the last step). Then, in the same group, the
    serving copy (``dist_serve``), LoRA placed (``dist_lora``) and
    compress-seq placed (``dist_compress``), each beside its unplaced run.
    A world of 1 calls no collective and cuts no int8 block: the multi-rank
    cases are held to JAX on the CPU (``tests/test_torch_dist_*.py``).
    Returns (launches, steps, the serving copy's launches, the gathered
    int8 state on the CPU, LoRA's launches, compress-seq's launches);
    ``phase_bench_recipe`` then takes the same steps from the same weights
    in one process and holds the two against each other (the int8 states
    after step INT8_SAME_WEIGHTS_STEP)."""
    import copy
    import tempfile

    from torch.distributed.tensor import DTensor

    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.parallel import bootstrap
    from v2pe_tpu_torch.parallel.context import ShardingContext
    from v2pe_tpu_torch.parallel.mesh import shard_model
    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID, make_synthetic_batch
    from v2pe_tpu_torch.train.train_step import make_train_step

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = bootstrap.initialize_distributed(
            device=device, init_method=f"file://{tmp}/store")
        try:
            import torch.distributed as dist

            backend, world = dist.get_backend(), dist.get_world_size()
            ctx = ShardingContext.from_mesh(config.MeshConfig())
            placed = shard_model(copy.deepcopy(model), cfg, ctx)
            n_dt = sum(isinstance(p, DTensor) for p in placed.parameters())
            opt = build_optimizer(train_config(), placed, cfg)
            step = make_train_step(cfg, opt, config.MeshConfig(),
                                   img_context_token_id=IMG_CONTEXT_ID,
                                   remat="full")
            batch = bootstrap.make_global_batch(make_synthetic_batch(
                cfg, 1, TRAIN_TOKENS, tiles_per_row=TRAIN_TILES, stride=64),
                ctx, torch.device(device))
            state = opt.init()
            setup_s = time.perf_counter() - t0
            placed.train()
            reset_launches()
            moments = {}
            steps = timed_steps(
                "dist train (world 1, NCCL, FSDP2)", step, placed, state,
                batch, lambda i: moments.update(int8_on_card(
                    placed, state, f"dist train after step {i}"))
                if i == INT8_SAME_WEIGHTS_STEP else None)
            counts = read_launches()
            del placed, opt, state, step
            torch.cuda.empty_cache()
            serve_counts = dist_serve(model, cfg, ctx)
            lora_counts = dist_lora(model, cfg, ctx, batch)
            compress_counts = dist_compress(model, cfg, ctx, batch)
        finally:
            bootstrap.shutdown()
    torch.cuda.empty_cache()
    ms = sorted(m["ms"] for m in steps[1:])[len(steps[1:]) // 2]
    log(f"dist train: launcher {env.launcher}, backend {backend}, world "
        f"{world}, mesh (data, fsdp, seq, tensor) = (1, 1, 1, 1); {n_dt} "
        f"DTensor parameters under FSDP2; set-up {setup_s:.1f} s; median of "
        f"steps 2-{BENCH_STEPS} {ms:.1f} ms = "
        f"{TRAIN_TOKENS / ms * 1e3:.0f} tok/s")
    check_train_steps(cfg, steps, BENCH_STEPS, "dist train")
    if n_dt != sum(1 for _ in model.parameters()):
        raise AssertionError("dist train: not every parameter is a DTensor")
    return counts, steps, serve_counts, moments, lora_counts, compress_counts


def int8_bytes(model, state, where: str) -> None:
    """Log the bytes of a run's int8 Adam state on the card beside the
    fp32 moments it stands for (two a trained value)."""
    from v2pe_tpu_torch.parallel.mesh import local

    held = sum(t.numel() * t.element_size()
               for mom in state["moments"].values() for t in mom.values())
    n = sum(local(p).numel() for p in model.parameters())
    log(f"{where}: int8 Adam state {held / 2 ** 20:.2f} MiB on the card "
        f"({held / n:.4f} bytes a trained value) against fp32 moments' "
        f"{8 * n / 2 ** 20:.2f} MiB ({card_line()})")


def int8_on_card(model, state, where: str, to_cpu: bool = True) -> dict:
    """The int8 Adam state of a run (its bytes logged by ``int8_bytes``),
    gathered to one device's layout (JAX's flat order): a copy (on the
    CPU with ``to_cpu``) that later steps leave as it is."""
    from v2pe_tpu_torch.parallel.mesh import placement_of

    int8_bytes(model, state, where)
    moments = state["moments"]
    placement = placement_of(model)
    if placement is not None:
        moments = placement.gather_state(model, state)["moments"]
    return {k: {t: v.to("cpu", copy=True) if to_cpu else v.clone()
                for t, v in mom.items()} for k, mom in moments.items()}


def _dequantized(mom: dict, tag: str, dev) -> torch.Tensor:
    """A leaf's first (m) or second (v) moment from its int8 state, as
    ``train/adam8bit.py`` reads it back (v: the square of its code)."""
    from v2pe_tpu_torch.train.adam8bit import BLOCK

    code, scale = mom[f"{tag}_code"].to(dev), mom[f"{tag}_scale"].to(dev)
    n = code.numel()
    x = torch.cat([code, code.new_zeros(scale.numel() * BLOCK - n)]).view(
        -1, BLOCK).float()
    return ((x if tag == "m" else x * x) * scale[:, None]).view(-1)[:n]


def compare_int8(got: dict, want: dict, where: str) -> None:
    """Two int8 Adam states of one device's layout, leaf by leaf: the
    moments they hold within two code steps of the leaf's largest block
    (2/127 of its largest value: a value on a rounding tie lands one step
    away where the two runs' gradients differ in their last bits) and at
    most 1 in 10^4 codes off. A block whose gradients are rounding noise
    (the ViT's key bias: the softmax cancels its gradient) may hold other
    codes by many steps at no weight. Logs the codes off, the leaves with
    the largest steps, and the largest moment difference."""
    if set(got) != set(want):
        raise AssertionError(f"{where}: int8 leaves differ")
    off = total = 0
    worst_code, worst, by_leaf = 0, 0.0, {}
    for key in want:
        for tag in ("m", "v"):
            dev = want[key][f"{tag}_code"].device  # compared where want is
            d = (got[key][f"{tag}_code"].to(dev).int()
                 - want[key][f"{tag}_code"].int()).abs()
            n_off = int((d > 0).sum())
            off += n_off
            total += d.numel()
            if n_off:
                by_leaf[f"{key} {tag}"] = (n_off, int(d.max()))
                worst_code = max(worst_code, int(d.max()))
            w = _dequantized(want[key], tag, dev)
            dm = (_dequantized(got[key], tag, dev) - w).abs().max() / \
                w.abs().max().clamp_min(1e-30) if w.numel() else 0.0
            worst = max(worst, float(dm))
            del d, w
    top = sorted(by_leaf.items(), key=lambda kv: -kv[1][1])[:4]
    log(f"{where}: int8 codes equal {total - off}/{total} (largest step "
        f"{worst_code}; the leaves off, codes off and largest step: {top}); "
        f"moments within {worst:.2e} of each leaf's largest (limit "
        f"{2 / 127:.2e}); {len(want)} leaves in JAX's flat order")
    if off > 1e-4 * total or worst > 2 / 127:
        raise AssertionError(f"{where}: int8 states disagree")


def dist_lora(model, cfg, ctx, batch) -> dict:
    """LoRA on the mesh (world 1): the trainer's adapters (ranks LORA_LLM_R /
    LORA_VIT_R from its seed) over a frozen view of the weights placed by
    ``place_lora`` (FSDP2 per layer; the adapters beside it), BENCH_STEPS
    steps of ``make_train_step(lora=True)`` on the bench batch, then the
    same from the same adapters unplaced (``lora_view``): losses and grad
    norms step by step within RING_TRAIN_TOL, the adapters after the last
    step within 2 x BENCH_STEPS x lr (a step of Adam moves a value by at
    most about lr); the base untouched. Returns the placed run's
    launches."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.models.lora import build_lora, whole_lora
    from v2pe_tpu_torch.parallel.mesh import place_lora
    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID
    from v2pe_tpu_torch.train.train_step import make_train_step

    tc = train_config()
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs, counts = {}, None
    for placed in (True, False):
        dev = next(model.parameters()).device
        lora = build_lora(torch.Generator(dev).manual_seed(42 ^ 0x10BA),
                          model, backbone_r=LORA_VIT_R, llm_r=LORA_LLM_R)
        base = place_lora(model, lora, cfg, ctx) if placed else model
        opt = build_optimizer(tc, lora, cfg)
        step = make_train_step(cfg, opt, config.MeshConfig() if placed
                               else None, img_context_token_id=IMG_CONTEXT_ID,
                               remat="full", lora=True)
        state = opt.init()
        base.train()
        torch.cuda.synchronize()
        reset_launches()
        what = "placed" if placed else "unplaced"
        steps = timed_steps(f"dist lora ({what})",
                            lambda m, s, b: step(lora, s, b, base), base,
                            state, batch)
        if placed:
            counts = read_launches()
            int8_bytes(lora, state, "dist lora (placed)")
        base.eval()
        runs[what] = (steps, whole_lora(lora).state_dict())
        del base, opt, state, step, lora
        torch.cuda.empty_cache()
    check_train_steps(cfg, runs["placed"][0], BENCH_STEPS, "dist lora")
    rel = step_rel(runs["placed"][0], runs["unplaced"][0])
    a, b = runs["placed"][1], runs["unplaced"][1]
    diff = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    moved = max(float((a[k].float() - b[k].float()).abs().max()) for k in b
                if k.endswith(".B"))
    limit = 2 * BENCH_STEPS * tc.learning_rate
    changed = [k for k, v in model.state_dict().items()
               if not same_bits(v, before[k])]
    ms = [sorted(m["ms"] for m in runs[w][0][1:])[len(runs[w][0][1:]) // 2]
          for w in ("placed", "unplaced")]
    log(f"dist lora: {len(b) // 3} adapters placed beside the FSDP2 view; "
        f"median of steps 2-{BENCH_STEPS} {ms[0]:.1f} ms placed, {ms[1]:.1f} "
        f"unplaced; loss rel {[f'{r[0]:.2e}' for r in rel]}, grad_norm rel "
        f"{[f'{r[1]:.2e}' for r in rel]} (tol {RING_TRAIN_TOL}); adapters "
        f"after step {BENCH_STEPS}: max |placed - unplaced| {diff:.2e} (B "
        f"{moved:.2e}; limit {limit:.1e}); base tensors changed "
        f"{len(changed)} ({card_line()})")
    if any(r[0] > RING_TRAIN_TOL["loss"] or r[1] > RING_TRAIN_TOL["grad_norm"]
           for r in rel) or diff > limit or changed:
        raise AssertionError("dist lora: the placed run disagrees with the "
                             "unplaced one")
    return counts


def step_rel(got: list, want: list) -> list:
    """(loss, grad_norm) relative differences, step by step."""
    return [(abs(a["loss"] - b["loss"]) / abs(b["loss"]),
             abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"]))
            for a, b in zip(got, want)]


def dist_compress(model, cfg, ctx, batch) -> dict:
    """Compress-seq on the mesh (world 1): the 'add' module built from the
    decoder, a copy of the model placed by ``shard_model`` (each decoder
    layer's compress part through its FSDP2 unit, the compress parameters
    in the root unit), BENCH_STEPS bench-recipe steps in COMPRESS_CHUNKS
    chunks, then the same unplaced: losses and grad norms within
    RING_TRAIN_TOL step by step. Returns the placed run's launches."""
    import copy

    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.models.compress_seq import init_compress_params
    from v2pe_tpu_torch.parallel.mesh import shard_model
    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID
    from v2pe_tpu_torch.train.train_step import make_train_step

    cfg_c = dataclasses.replace(cfg, compress_seq=True, fuse_method="add",
                                chunk_num=COMPRESS_CHUNKS)
    runs, counts = {}, None
    for placed in (True, False):
        m = copy.deepcopy(model)
        m.compress = init_compress_params(m.llm, cfg=cfg.llm)
        if placed:
            shard_model(m, cfg_c, ctx)
        opt = build_optimizer(train_config(), m, cfg_c)
        step = make_train_step(cfg_c, opt, config.MeshConfig() if placed
                               else None, img_context_token_id=IMG_CONTEXT_ID,
                               remat="full")
        state = opt.init()
        m.train()
        torch.cuda.synchronize()
        reset_launches()
        what = "placed" if placed else "unplaced"
        runs[what] = timed_steps(f"dist compress ({what})", step, m, state,
                                 batch)
        if placed:
            counts = read_launches()
            int8_bytes(m, state, "dist compress (placed)")
        del m, opt, state, step
        torch.cuda.empty_cache()
    check_compress_steps(cfg, runs["placed"], "dist compress")
    rel = step_rel(runs["placed"], runs["unplaced"])
    ms = [sorted(x["ms"] for x in runs[w][1:])[len(runs[w][1:]) // 2]
          for w in ("placed", "unplaced")]
    log(f"dist compress (add, {COMPRESS_CHUNKS} chunks): median of steps "
        f"2-{BENCH_STEPS} {ms[0]:.1f} ms placed, {ms[1]:.1f} unplaced; loss "
        f"rel {[f'{r[0]:.2e}' for r in rel]}, grad_norm rel "
        f"{[f'{r[1]:.2e}' for r in rel]} (tol {RING_TRAIN_TOL}) "
        f"({card_line()})")
    if any(r[0] > RING_TRAIN_TOL["loss"] or r[1] > RING_TRAIN_TOL["grad_norm"]
           for r in rel):
        raise AssertionError("dist compress: the placed run disagrees with "
                             "the unplaced one")
    return counts


TWO_RANK_TOKENS, TWO_RANK_STEPS = 2048, 2  # a row a rank, one tile each
# the vocab of the two-rank phase: a tenth of InternVL2's 92,553, still no
# multiple of 256, so the head's int8 blocks are cut between the ranks;
# the root unit's host-staged gathers shrink with it
TWO_RANK_VOCAB = 9257


def two_rank_cfg(cfg):
    """InternVL2-2B's hidden widths at 2 layers a tower and a vocab of
    TWO_RANK_VOCAB."""
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=2),
        llm=dataclasses.replace(cfg.llm, num_hidden_layers=2,
                                vocab_size=TWO_RANK_VOCAB))


def two_rank_recipes(cfg, device, ctx=None) -> dict:
    """The three recipes of this slice on a model drawn from seed 0 (fp32:
    bf16 gradients summed over two ranks round twice, which moves int8
    codes by a few steps and would hide a fault),
    TWO_RANK_STEPS steps each on make_synthetic_batch's 2 rows of
    TWO_RANK_TOKENS tokens and a tile: the bench recipe with int8 Adam,
    LoRA (the trainer's ranks and seed), compress-seq ('add', 4 chunks).
    With ``ctx`` (fsdp 2) each is placed and each rank takes its row.
    Returns, per recipe, the (loss, grad norm) of each step and, on the
    CPU, the int8 state gathered to one device's layout or the adapters
    whole."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.models.compress_seq import init_compress_params
    from v2pe_tpu_torch.models.lora import build_lora, whole_lora
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.parallel import bootstrap
    from v2pe_tpu_torch.parallel.mesh import (place_lora, placement_of,
                                              shard_model)
    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID, make_synthetic_batch
    from v2pe_tpu_torch.train.train_step import make_train_step

    mesh = config.MeshConfig(fsdp=2) if ctx is not None else None
    b = make_synthetic_batch(cfg, 2, TWO_RANK_TOKENS, tiles_per_row=1,
                             stride=64)
    # the image tokens (92544-92546) onto the vocab's last three ids
    shift = IMG_CONTEXT_ID - (cfg.llm.vocab_size - 1)
    for k in ("input_ids", "targets"):
        b[k] = np.where(b[k] >= IMG_CONTEXT_ID - 2, b[k] - shift, b[k])
    if ctx is not None:
        b = bootstrap.rows_of_global_batch(b, ctx.dp_index, ctx.dp_size,
                                           cfg.num_image_token)
    batch = bootstrap.make_global_batch(b, ctx, device) if ctx is not None \
        else {k: torch.as_tensor(v).to(device) for k, v in b.items()}
    out = {}
    for recipe in ("int8", "lora", "compress"):
        rc = cfg if recipe != "compress" else dataclasses.replace(
            cfg, compress_seq=True, fuse_method="add",
            chunk_num=COMPRESS_CHUNKS)
        model = init_vlm_params(rc, torch.Generator(device).manual_seed(0),
                                device=device, dtype=torch.float32)
        trained, forward = model, model
        if recipe == "compress":
            model.compress = init_compress_params(model.llm, cfg=rc.llm)
        if recipe == "lora":
            trained = build_lora(
                torch.Generator(device).manual_seed(42 ^ 0x10BA), model,
                backbone_r=LORA_VIT_R, llm_r=LORA_LLM_R)
            if ctx is not None:
                forward = place_lora(model, trained, rc, ctx)
        elif ctx is not None:
            shard_model(model, rc, ctx)
        opt = build_optimizer(train_config(), trained, rc)
        step = make_train_step(rc, opt, mesh, lora=recipe == "lora",
                               img_context_token_id=IMG_CONTEXT_ID - shift,
                               remat="full")
        state = opt.init()
        forward.train()
        steps = []
        for _ in range(TWO_RANK_STEPS):
            loss, gnorm = step(trained, state, batch, forward) \
                if recipe == "lora" else step(model, state, batch)
            steps.append((loss.item(), gnorm.item()))
        rec = {"steps": steps}
        if recipe == "int8":
            rec["moments"] = int8_on_card(model, state, f"two ranks "
                                          f"({'fsdp 2' if ctx else 'one'})")
        if recipe == "lora":
            rec["adapters"] = {k: v.cpu() for k, v in
                               whole_lora(trained).state_dict().items()}
        out[recipe] = rec
        del model, trained, forward, opt, state, step
        torch.cuda.empty_cache()
    return out


def _two_rank_worker(rank: int, store: str, result: str, cfg,
                     device: str) -> None:
    """One of two processes on the one card: gloo over CUDA tensors
    (NCCL refuses a second rank on a device), the mesh fsdp = 2, the
    recipes of ``two_rank_recipes`` placed; rank 0 saves the results."""
    import traceback

    os.environ.update(V2PE_NUM_PROCESSES="2", V2PE_PROCESS_ID=str(rank))
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.parallel import bootstrap
    from v2pe_tpu_torch.parallel.context import ShardingContext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        bootstrap.initialize_distributed(
            device=device, init_method=f"file://{store}", backend="gloo")
        ctx = ShardingContext.from_mesh(config.MeshConfig(fsdp=2))
        out = two_rank_recipes(cfg, torch.device(
            "cuda", torch.cuda.current_device()) if device == "cuda"
            else torch.device(device), ctx)
        if rank == 0:
            torch.save(out, result)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # a peer in a collective must not hang us
    finally:
        bootstrap.shutdown()


def phase_two_ranks(device: str = "cuda", cfg=None,
                    start: str = "spawn") -> None:
    """Two processes on the one card as a mesh of fsdp = 2 over gloo (the
    collectives staged through the host; NCCL refuses two ranks on one
    device, ``tests/torch_two_ranks_one_card.py``), at InternVL2-2B's
    hidden widths, 2 layers a tower and a vocab of TWO_RANK_VOCAB: int8
    Adam with blocks cut between the ranks (the head's), LoRA placed,
    compress-seq placed, each held to the
    same recipe run unplaced in this process on both rows: losses and grad
    norms within RING_TRAIN_TOL, the int8 state by ``compare_int8``, the
    adapters within 2 x steps x lr. Fails the run when a rank fails."""
    import tempfile

    import torch.multiprocessing as mp

    from v2pe_tpu_torch import config

    cfg = cfg or two_rank_cfg(config.internvl2_2b())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "ranks.pt")
        spawn = mp.get_context(start)
        procs = [spawn.Process(target=_two_rank_worker, args=(
            r, os.path.join(tmp, "store"), result, cfg, device))
            for r in range(2)]
        for p in procs:
            p.start()
        want = two_rank_recipes(cfg, torch.device(device))
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0] or not os.path.exists(result):
            raise AssertionError(f"two ranks on one card: exit codes {codes}")
        got = torch.load(result)
    wall = time.perf_counter() - t0
    for recipe in ("int8", "lora", "compress"):
        rel = step_rel([dict(loss=a, grad_norm=b)
                        for a, b in got[recipe]["steps"]],
                       [dict(loss=a, grad_norm=b)
                        for a, b in want[recipe]["steps"]])
        log(f"two ranks ({recipe}, fsdp 2 over gloo on one card): losses "
            f"{[round(a, 4) for a, _ in got[recipe]['steps']]}, loss rel "
            f"{[f'{r[0]:.2e}' for r in rel]}, grad_norm rel "
            f"{[f'{r[1]:.2e}' for r in rel]} against one process (tol "
            f"{RING_TRAIN_TOL})")
        if any(r[0] > RING_TRAIN_TOL["loss"]
               or r[1] > RING_TRAIN_TOL["grad_norm"] for r in rel):
            raise AssertionError(f"two ranks ({recipe}) disagree with one "
                                 f"process")
    compare_int8(got["int8"]["moments"], want["int8"]["moments"],
                 "two ranks (int8)")
    a, b = got["lora"]["adapters"], want["lora"]["adapters"]
    diff = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    limit = 2 * TWO_RANK_STEPS * train_config().learning_rate
    log(f"two ranks (lora): adapters max |fsdp 2 - one| {diff:.2e} (limit "
        f"{limit:.1e}); phase wall {wall:.1f} s ({card_line()})")
    if diff > limit:
        raise AssertionError("two ranks (lora): adapters disagree")


def dist_serve(model, cfg, ctx) -> dict:
    """Serving on a mesh of processes, as the world of 1 of phase 20's
    process group: a copy of the model placed by ``shard_model`` (FSDP2 per
    layer, DTensor parameters; the root's gathered once by the placement,
    ``serving=True``, each layer's by its hooks at its call), paged generate of a 2048-token
    prompt and 16 new tokens under the mesh's context, against the same on
    the unplaced model. One pool shard and one tensor rank: the pool's
    merge and the tensor all-reduces are not called, so this holds the
    placement and the hooks, not the collectives. Returns the launches."""
    import copy

    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.parallel.context import use_sharding
    from v2pe_tpu_torch.parallel.mesh import shard_model

    S = 2048
    rng = np.random.default_rng(43)
    args = (torch.as_tensor(rng.integers(10, cfg.llm.vocab_size - 2,
                                         (1, S))), torch.tensor([S]),
            torch.arange(S, dtype=torch.float32)[None],
            torch.zeros(1, 3, 448, 448), torch.zeros(1, dtype=torch.int32),
            -1)
    gc = dict(max_new_tokens=16)
    ref, _, _ = generate(model, cfg, GenerationConfig(**gc), *args,
                         cache_mode="paged", page_size=512)
    placed = shard_model(copy.deepcopy(model).eval(), cfg, ctx,
                         serving=True)
    with use_sharding(ctx):
        reset_launches()
        t0 = time.perf_counter()
        got, _, lens = generate(placed, cfg, GenerationConfig(**gc), *args,
                                cache_mode="paged", page_size=512)
        counts = read_launches()
    dt = time.perf_counter() - t0
    del placed
    torch.cuda.empty_cache()
    log(f"dist serve (world 1, NCCL, FSDP2): paged generate of {S} tokens "
        f"and {int(lens[0])} new in {dt:.3f}s through shard_model's "
        f"placement; greedy tokens equal to the unplaced model's "
        f"{_shared(got[0].tolist(), ref[0].tolist())}; launches {counts}")
    if not torch.equal(got, ref):
        raise AssertionError(f"dist serve: {got} against {ref}")
    require(counts, ("flash_fwd", "paged_decode"), "dist serve")
    require_riding_store(counts, "dist serve")
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


# --------------------------------------- sequence parallelism (the ring)


RING_SHARDS = 4
RING_EVAL_TOKENS, RING_EVAL_TILES = 32768, 32


def _zigzag(x: torch.Tensor, world: int, axis: int = 1) -> torch.Tensor:
    """Global order -> the layout whose contiguous shards are the ranks'."""
    from v2pe_tpu_torch.parallel import ring

    return torch.cat([ring.zigzag_shard(x, r, world, axis=axis)
                      for r in range(world)], dim=axis).contiguous()


def ring_forms(device):
    """(name, ranks, unsharded args, kwargs) of every form the fused ring
    forward is held at. Main: 4 ranks, causal, 32,768 tokens, 16/8 heads of
    128, bf16, three packed segments and a padded tail (the long eval's
    shape), and the same at 8192 tokens (the ring trainer's shape). Then 8
    ranks in fp32 at the JAX ring test's shape (512 tokens, 4/2 x 16, three segments + 8 padded), a
    bidirectional form, batch 2 with shards that no 64-row tile divides and
    a batch row whose first shard is all padding, and one rank. The args
    are in global order with arange positions; the ring gets them
    zigzag-permuted."""
    g = torch.Generator(device="cpu").manual_seed(6)

    def form(name, world, B, S, Hq, Hkv, D, dtype, pad, causal=True):
        q, k, v = (torch.randn(B, S, H, D, generator=g).to(device, dtype)
                   for H in (Hq, Hkv, Hkv))
        seg = torch.ones(B, S, dtype=torch.int32, device=device)
        seg[:, S // 3: 2 * S // 3] = 2
        seg[:, 2 * S // 3:] = 3
        seg[:, S - pad:] = 0
        if B > 1:  # the last rank's low half and rank 0's shard, in zigzag
            seg[1, :S // world // 2] = 0
            seg[1, S - S // world // 2:] = 0
        pos = torch.arange(S, dtype=torch.int32,
                           device=device).expand(B, S).contiguous()
        return name, world, (q, k, v, seg, seg, pos, pos), dict(
            causal=causal, scale=D ** -0.5)

    bf16, f32 = torch.bfloat16, torch.float32
    return [
        form("ring4_zigzag_32768_3seg_pad_bf16", RING_SHARDS,
             1, RING_EVAL_TOKENS, LLM_HQ, LLM_HKV, LLM_HD, bf16, 200),
        form(f"ring4_zigzag_{TRAIN_TOKENS}_3seg_pad_bf16", RING_SHARDS,
             1, TRAIN_TOKENS, LLM_HQ, LLM_HKV, LLM_HD, bf16, 72),
        form("ring8_zigzag_512_3seg_pad_fp32", 8, 1, 512, 4, 2, 16, f32, 8),
        form("ring4_noncausal_1024_fp32", 4, 1, 1024, 4, 2, 64, f32, 8,
             causal=False),
        form("ring4_B2_2000_ragged_tiles_bf16", 4, 2, 2000, LLM_HQ, LLM_HKV,
             LLM_HD, bf16, 40),
        form("ring1_300_bf16", 1, 1, 300, LLM_HQ, LLM_HKV, LLM_HD, bf16, 10),
    ]


def ring_library_ms(world, zz, causal: bool, scale: float):
    """One ``scaled_dot_product_attention`` call that computes the ring
    forward of every rank: the ranks as the batch, each with its chunks
    gathered in hop order, the kv heads repeated to the query heads and the
    segment / position mask made explicit (all outside the timing). No
    call without an explicit mask expresses the zigzag layout."""
    import torch.nn.functional as F

    q, k, v, seg_q, seg_k, pos_q, pos_k = zz
    B, S, Hq, D = q.shape
    Sl, G = S // world, Hq // k.shape[2]
    order = torch.tensor([[(r - s) % world for s in range(world)]
                          for r in range(world)], device=q.device)

    def gathered(x):  # (B, S, ...) -> (world * B, S, ...), rank-major
        chunks = x.reshape(B, world, Sl, *x.shape[2:])
        return chunks[:, order].transpose(0, 1).reshape(
            world * B, S, *x.shape[2:])

    def ranks(x):     # (B, S, ...) -> (world * B, Sl, ...)
        return x.reshape(B, world, Sl, *x.shape[2:]).transpose(0, 1).reshape(
            world * B, Sl, *x.shape[2:])

    qr = ranks(q).transpose(1, 2)
    kg = gathered(k).repeat_interleave(G, dim=2).transpose(1, 2)
    vg = gathered(v).repeat_interleave(G, dim=2).transpose(1, 2)
    sq, sk = ranks(seg_q)[:, :, None], gathered(seg_k)[:, None, :]
    mask = (sq == sk) & (sq != 0)
    if causal:
        mask &= ranks(pos_q)[:, :, None] >= gathered(pos_k)[:, None, :]
    mask = mask[:, None]
    return library_ms(lambda: F.scaled_dot_product_attention(
        qr, kg, vg, attn_mask=mask, scale=scale), iters=2)


def ring_rectangles(name, world, zz, kw, grads=None) -> dict:
    """The flash kernels at the shapes the ring gives them: for every
    distinct branch of the ring's schedule (a full shard against a full
    chunk, against a chunk's low half, a shard's high half against a full
    chunk, ...) the first (rank, chunk) pair that takes it. On that
    rectangle's rows, with their zigzag positions, the forward kernel is
    held against its plain twin; with ``grads`` = (out, lse, do) of the
    whole ring, also the two backward kernels against theirs, on the ring's
    out and lse as the ring's second pass hands them over. Returns form
    records per kernel."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd
    from v2pe_tpu_torch.parallel import ring

    statics = ring.RingStatics(kw["causal"], kw["scale"])
    schedule = ring.ring_schedule(statics, world, *zz[3:])
    shard_len = zz[0].shape[1] // world
    first = {}
    for r, c in itertools.product(range(world), repeat=2):
        if schedule[r][c]:
            first.setdefault(schedule[r][c], (r, c))
    records = {"flash_fwd": [], **{n: [] for n in BWD_KERNELS}}
    for branch, (r, c) in sorted(first.items()):
        qr, kr = ring._rectangle(branch, r, c, shard_len)
        rows = (qr, kr, kr, qr, kr, qr, kr)
        args = [ring._rows(t, sl) for t, sl in zip(zz, rows)]
        form = (f"{name}_rect{branch}_{args[0].shape[1]}x{args[1].shape[1]}")
        out, lse = flash_fwd.flash_attention_fwd(*args, **kw)
        text, err = check_flash(form, args, kw, out, lse)
        msg = ""
        ok = True
        records["flash_fwd"].append(dict(form=form, max_abs_err=err,
                                         main=False))
        if grads is not None:
            full = (*args, ring._rows(grads[0], qr),
                    ring._rows(grads[1], qr, axis=2), ring._rows(grads[2], qr))
            btext, bok, berr, brel = check_bwd(
                full, kw, flash_bwd.flash_attention_bwd(*full, **kw))
            msg = f"; backward {btext}"
            ok = ok and bok
            for n in BWD_KERNELS:
                records[n].append(dict(form=form, max_abs_err=berr,
                                       max_rel_err=brel, main=False))
            del full
        log(f"kernel ring rectangle {form} (rank {r} x chunk {c}): forward "
            f"{text}{msg}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with twin at {form}")
    return records


def check_ring(world, zz, kw, out, lse):
    """The fused ring forward's (out, lse) against its plain version on the
    same inputs and, in bf16, on fp32 copies of them; both at TOL (nothing
    is rotated in this kernel). Returns the errors as text, whether every
    one is within its limit, and the largest on the same inputs."""
    from v2pe_tpu_torch.parallel import ring_fused

    def errs(ts):
        ref = ring_fused.fused_ring_fwd_torch(world, *ts, **kw)
        return ((out.float() - ref[0].float()).abs().max().item(),
                (lse - ref[1]).abs().max().item())

    tol = TOL[zz[0].dtype]
    checks = [("plain", errs(zz))]
    if zz[0].dtype == torch.bfloat16:
        checks.append(("fp32 plain", errs(
            [a.float() if a.is_floating_point() else a for a in zz])))
    text = " ".join(f"max|out-{what}| {e[0]:.3e} max|lse-{what}| {e[1]:.3e}"
                    for what, e in checks)
    ok = bool(torch.isfinite(out).all()) and all(
        e[0] <= tol["out"] and e[1] <= tol["lse"] for _, e in checks)
    return (f"{text} (tol {tol['out']} / {tol['lse']})", ok,
            max(checks[0][1]))


def phase_ring_kernel() -> dict:
    """The fused ring forward against its plain version at every form, and
    against the flash forward kernel on the unsharded sequence (an
    independent check of the layout: zigzag_unshard of the ring's output is
    plain causal attention), with the tolerances of the flash forward. At
    the two full-width forms also the flash forward at the scan ring's
    rectangles against its plain twin. At the main form also: the scan
    ring's output and its launches (at most ranks x ranks flash launches,
    less the skipped pairs) against the fused ring's one, and the
    synchronising reads of the card each makes. Returns form records per
    kernel."""
    from v2pe_tpu_torch.ops import flash_fwd
    from v2pe_tpu_torch.parallel import ring, ring_fused

    records, rect_records = [], []
    for name, world, args, kw in ring_forms(torch.device("cuda")):
        main = name.startswith(f"ring4_zigzag_{RING_EVAL_TOKENS}")
        zz = [_zigzag(a, world) for a in args]
        dtype = args[0].dtype
        out, lse = ring_fused.fused_ring_fwd(world, *zz, **kw)
        torch.cuda.synchronize()
        text, ok, err = check_ring(world, zz, kw, out, lse)
        tol = TOL[dtype]
        msg = ""
        if args[0].shape[3] in flash_fwd.HEAD_DIMS:
            o1, l1 = flash_fwd.flash_attention_fwd(*args, **kw)
            d_out = (ring.zigzag_unshard(out, world).float()
                     - o1.float()).abs().max().item()
            d_lse = (ring.zigzag_unshard(lse, world, axis=2)
                     - l1).abs().max().item()
            msg = (f"; against flash_fwd on the unsharded sequence max|dout| "
                   f"{d_out:.3e} max|dlse| {d_lse:.3e}")
            ok = ok and d_out <= tol["out"] and d_lse <= tol["lse"]
            del o1, l1
        iters = 3 if main else 5
        ms = time_ms(lambda: ring_fused.fused_ring_fwd(world, *zz, **kw),
                     iters=iters)
        plain_ms = time_ms(
            lambda: ring_fused.fused_ring_fwd_torch(world, *zz, **kw),
            iters=2 if main else 5)
        q, k, v, seg_q, seg_k, pos_q, pos_k = args
        pairs = attended_pairs(seg_q, seg_k, pos_q, pos_k, kw["causal"])
        bound = attention_roof(q, k, v, pairs, 2, out, lse)
        lib = ring_library_ms(world, zz, kw["causal"], kw["scale"]) \
            if main else None
        log(f"kernel ring_fused_fwd {name}: {text}{msg}; kernel {ms:.3f} ms "
            f"({useful_tflops(q, pairs, ms):.1f} TFLOP/s useful), plain "
            f"{plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']} ({pairs} attended pairs a head), library "
            f"(scaled_dot_product_attention, ranks as the batch, explicit "
            f"mask) {'none' if lib is None else f'{lib:.3f} ms'}")
        if not ok:
            raise AssertionError(f"fused ring forward disagrees at {name}")
        records.append(dict(form=name, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, **bound, library_ms=lib,
                            main=main))
        if name.startswith("ring4_zigzag"):
            rect_records += ring_rectangles(name, world, zz, kw)["flash_fwd"]
        if not main:
            continue
        statics = ring.RingStatics(kw["causal"], kw["scale"])
        reset_launches()
        (s_out, s_lse), scan_reads = count_syncs(
            lambda: ring._ring_fwd_impl(world, statics, *zz))
        scan_n = read_launches()["flash_fwd"]
        reset_launches()
        _, fused_reads = count_syncs(
            lambda: ring_fused.fused_ring_fwd(world, *zz, **kw))
        fused_n = read_launches()["ring_fused_fwd"]
        live = int((ring.branch_table(statics, world, *zz[3:]) != 0).sum())
        d_out = (s_out.float() - out.float()).abs().max().item()
        d_lse = (s_lse - lse).abs().max().item()
        scan_ms = time_ms(lambda: ring._ring_fwd_impl(world, statics, *zz),
                          iters=3, behind_spin=False)
        log(f"ring scan vs fused at {name}: max|dout| {d_out:.3e} (tol "
            f"{tol['out']}) max|dlse| {d_lse:.3e} (tol {tol['lse']}); scan "
            f"{scan_n} flash_fwd launches ({live} live of {world * world} "
            f"(rank, chunk) pairs), {scan_reads} read of the card, "
            f"{scan_ms:.3f} ms; fused {fused_n} launch, {fused_reads} reads, "
            f"{ms:.3f} ms")
        if d_out > tol["out"] or d_lse > tol["lse"] or scan_n != live \
                or scan_n > world * world or fused_n != 1 \
                or scan_reads != 1 or fused_reads != 0:
            raise AssertionError("scan and fused ring disagree, or their "
                                 "launches or reads are not as designed")
        del s_out, s_lse
    torch.cuda.empty_cache()
    return {"ring_fused_fwd": records, "flash_fwd": rect_records}


def phase_ring_bwd() -> dict:
    """The ring's training pass at the ring trainer's shape (4 ranks, 8192
    tokens, 16/8 x 128, bf16, three segments and a padded tail) and at a
    small fp32 form with batch 2. The fused forward's out and lse against
    its plain version on the zigzag inputs; the ring's backward (the second
    ring pass on the flash backward kernels) against the plain flash
    backward on the same unsharded inputs, out and lse, and against the
    dense flash backward kernels: dq, dk, dv relative to their range; then
    the three flash kernels at each rectangle the ring cuts, against their
    plain twins. Returns the rectangles' form records per kernel."""
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd
    from v2pe_tpu_torch.parallel import ring, ring_fused

    g = torch.Generator(device="cpu").manual_seed(9)
    records = {"flash_fwd": [], **{n: [] for n in BWD_KERNELS}}
    for name, B, S, Hq, Hkv, D, dtype in (
            (f"ring4_zigzag_{TRAIN_TOKENS}_3seg_pad_bf16", 1, TRAIN_TOKENS,
             LLM_HQ, LLM_HKV, LLM_HD, torch.bfloat16),
            ("ring4_B2_1024_fp32", 2, 1024, 4, 2, 64, torch.float32)):
        world = RING_SHARDS
        q, k, v = (torch.randn(B, S, H, D, generator=g).to("cuda", dtype)
                   for H in (Hq, Hkv, Hkv))
        seg = torch.ones(B, S, dtype=torch.int32, device="cuda")
        seg[:, S // 3: 2 * S // 3], seg[:, 2 * S // 3:] = 2, 3
        seg[:, S - 72:] = 0
        pos = torch.arange(S, dtype=torch.int32,
                           device="cuda").expand(B, S).contiguous()
        do = torch.randn(B, S, Hq, D, generator=g).to("cuda", dtype)
        kw = dict(causal=True, scale=D ** -0.5)
        up = lambda ts: [t.float() if t.is_floating_point() else t
                         for t in ts]
        zz = [_zigzag(x, world) for x in (q, k, v, seg, seg, pos, pos)]
        # the fused forward against its plain version, at this shape
        out_z, lse_z = ring_fused.fused_ring_fwd(world, *zz, **kw)
        ftext, fok, _ = check_ring(world, zz, kw, out_z, lse_z)
        # the ring's backward through autograd
        leaves = [x.clone().requires_grad_() for x in zz[:3]]
        reset_launches()
        o = ring_fused.fused_ring_attention(
            *leaves, seq_shards=world, q_segment_ids=zz[3],
            kv_segment_ids=zz[4], q_positions=zz[5], kv_positions=zz[6], **kw)
        do_z = _zigzag(do, world)
        o.backward(do_z)
        counts = read_launches()
        got = [ring.zigzag_unshard(x.grad, world) for x in leaves]
        # ... against the plain backward on the same out, lse and do
        out_g = ring.zigzag_unshard(out_z, world)
        lse_g = ring.zigzag_unshard(lse_z, world, axis=2)
        plain = flash_bwd.flash_attention_bwd_torch(
            *up((q, k, v, seg, seg, pos, pos, out_g, lse_g, do)), **kw)
        rels_plain = [((a.float() - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, plain)]
        del plain
        # ... and against the dense flash kernels on the unsharded sequence
        out, lse = flash_fwd.flash_attention_fwd(q, k, v, seg, seg, pos, pos,
                                                 **kw)
        want = flash_bwd.flash_attention_bwd(q, k, v, seg, seg, pos, pos,
                                             out, lse, do, **kw)
        rels = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item() for a, b in zip(got, want)]
        tol = BWD_TOL[dtype]
        live = int((ring.branch_table(ring.RingStatics(True, kw["scale"]),
                                      world, *zz[3:]) != 0).sum())
        log(f"kernel ring bwd {name}: fused forward against its plain "
            f"version {ftext}; fused forward + ring "
            f"backward against the plain flash backward, max|d|/max dq "
            f"{rels_plain[0]:.3e} dk {rels_plain[1]:.3e} dv "
            f"{rels_plain[2]:.3e}, against the dense flash backward kernels "
            f"dq {rels[0]:.3e} dk {rels[1]:.3e} dv {rels[2]:.3e} (tol "
            f"{tol:.3e}); launches ring_fused_fwd "
            f"{counts['ring_fused_fwd']}, flash_bwd_dkv "
            f"{counts['flash_bwd_dkv']}, flash_bwd_dq "
            f"{counts['flash_bwd_dq']} ({live} live pairs)")
        ok = all(torch.isfinite(t).all() for t in got) and fok \
            and max(rels + rels_plain) <= tol \
            and counts["ring_fused_fwd"] == 1 \
            and counts["flash_bwd_dkv"] == counts["flash_bwd_dq"] == live
        if not ok:
            raise AssertionError(f"ring backward disagrees at {name}")
        del got, want, leaves, o
        rect = ring_rectangles(name, world, zz, kw, (out_z, lse_z, do_z))
        for n in records:
            records[n] += rect[n]
    torch.cuda.empty_cache()
    return records


def phase_small_ring_reference(devices=("cpu", "cuda")) -> None:
    """A 2-layer fp32 model under ``seq_shards=4``, on the card (the
    kernels) against the CPU (their plain versions): the packed forward's
    logits in both ring modes (1e-4, and against the unsharded forward of
    the same device after un-permuting), then one train step through
    ``make_train_step(mesh=MeshConfig(seq=4), ring_mode='fused')``: loss,
    grad norm and every updated parameter as in the unsharded reference;
    then the teacher-forced eval, whose answer tokens must be identical in
    every run."""
    import copy

    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.evalkit import mm_niah_long as niah
    from v2pe_tpu_torch.models.internvl_chat import forward
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.parallel import context as pctx
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer
    from v2pe_tpu_torch.train.train_step import make_train_step

    cfg = config.VLMConfig(
        vision=config.VisionConfig(hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   image_size=112, patch_size=14),
        llm=config.LLMConfig(vocab_size=1000, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2)
    base = init_vlm_params(cfg, torch.Generator().manual_seed(23))
    tc = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=10,
                     use_8bit_optimizer=True)

    def logits(model, batch, ctx):
        with torch.inference_mode(), pctx.use_sharding(ctx):
            out = forward(model, cfg, input_ids=batch["input_ids"].long(),
                          pixel_values=batch["pixel_values"],
                          image_flags=batch["image_flags"],
                          rope_pos_ids=batch["rope_pos_ids"],
                          img_context_token_id=999,
                          segment_ids=batch["segment_ids"],
                          token_positions=batch["token_positions"],
                          vit_gather_idx=batch["vit_gather_idx"]).logits
        # back to global order; the padded tail's logits are not compared
        order = torch.argsort(batch["token_positions"], dim=1)
        live = torch.gather(batch["segment_ids"], 1, order) != 0
        return (torch.gather(out, 1, order[..., None].expand_as(out))
                * live[..., None]).cpu()

    res = {}
    for dev in devices:
        model = copy.deepcopy(base).to(dev)
        ring_batch = small_train_batch(cfg, dev, 320, RING_SHARDS)
        res[dev] = {"plain": logits(model, small_train_batch(cfg, dev, 320),
                                    None)}
        for mode in ("scan", "fused"):
            res[dev][mode] = logits(model, ring_batch, pctx.ShardingContext(
                seq_shards=RING_SHARDS, ring_mode=mode))
        model = model.train()
        opt = build_optimizer(tc, model, cfg)
        step = make_train_step(cfg, opt, config.MeshConfig(seq=RING_SHARDS),
                               img_context_token_id=999, remat="full",
                               ring_mode="fused")
        loss, gnorm = step(model, opt.init(), ring_batch)
        res[dev]["step"] = (loss.item(), gnorm.item(), {
            n: p.detach().cpu() for n, p in model.named_parameters()})
    cpu, gpu = (res[d] for d in devices)
    errs = {m: (gpu[m] - cpu[m]).abs().max().item()
            for m in ("plain", "scan", "fused")}
    sharded = max((gpu[m] - gpu["plain"]).abs().max().item()
                  for m in ("scan", "fused"))
    log(f"reference: small ring forward fp32 ({RING_SHARDS} shards, 320 "
        f"packed tokens), card vs CPU max|dlogit| unsharded "
        f"{errs['plain']:.3e} scan {errs['scan']:.3e} fused "
        f"{errs['fused']:.3e}; ring vs unsharded on the card {sharded:.3e} "
        f"(tol 1e-4, |logit| <= {cpu['plain'].abs().max().item():.3f})")
    (l_c, g_c, p_c), (l_g, g_g, p_g) = cpu["step"], gpu["step"]
    d_loss, d_gn = abs(l_g - l_c) / abs(l_c), abs(g_g - g_c) / abs(g_c)
    d_par = max(((p_g[n] - p_c[n]).abs().max() / (
        1e-4 * p_c[n].abs().max() + 1e-2 * tc.learning_rate)).item()
        for n in p_c)  # <= 1 passes
    log(f"reference: small ring train step fp32 (seq=4, fused, int8 Adam), "
        f"card vs CPU: loss {l_g:.6f} vs {l_c:.6f} (rel {d_loss:.2e}), "
        f"grad_norm {g_g:.6f} vs {g_c:.6f} (rel {d_gn:.2e}) (tol 1e-4); "
        f"params max|d| at {d_par:.2f} of the tolerance")
    if max(*errs.values(), sharded) > 1e-4 or max(d_loss, d_gn) > 1e-4 \
            or d_par > 1.0:
        raise AssertionError("card and CPU ring paths disagree")

    # the teacher-forced eval in fp32: the answer tokens of every run equal
    rng = np.random.default_rng(29)
    ids, pos = rng.integers(5, 990, 300), np.arange(300, dtype=np.float32)
    preds = []
    for dev in devices:
        model = copy.deepcopy(base).to(dev).eval()
        for shards, mode in ((1, "scan"), (RING_SHARDS, "scan"),
                             (RING_SHARDS, "fused")):
            inputs = niah.build_teacher_forced_inputs(
                ids, (284, 300), pos, seq_shards=shards, pad_multiple=64)
            with pctx.use_sharding(pctx.ShardingContext(
                    seq_shards=shards, ring_mode=mode)):
                preds.append(niah.teacher_forced_eval(
                    model, cfg, inputs, np.zeros((1, 3, 112, 112),
                                                 np.float32),
                    np.zeros(1, np.int32), 999))
    same = all(np.array_equal(p, preds[0]) for p in preds)
    log(f"reference: small teacher-forced eval fp32, 16 answer tokens of "
        f"unsharded / scan / fused on CPU and card identical {same}")
    if not same:
        raise AssertionError("teacher-forced predictions differ")


def needle_prompt(cfg, n_tokens: int, tiles: int, answer: int = 8):
    """A needle-in-a-haystack prompt as the MM-NIAH-long eval packs it: 16
    text tokens, ``tiles`` image tiles in one span, random text, and the
    last ``answer`` tokens as the gold answer; V2PE ids at stride 64.
    Returns (ids, answer span, rope ids, pixels, the flat ViT row of every
    token in global order)."""
    rng = np.random.default_rng(17)
    sample = synthetic_sample(rng, n_tokens, tiles, cfg.num_image_token, 448)
    ids = sample["input_ids"]
    is_ctx = ids == 92546
    gather = np.where(is_ctx, np.cumsum(is_ctx) - 1, -1).astype(np.int32)
    return (ids, (n_tokens - answer, n_tokens), sample["pos_ids"],
            sample["pixel_values"], gather)


def eval_logits(model, cfg, inputs, pixels, flags, idx, ctx):
    """The fp32 logits (S_pad, V) of the eval's forward under ``ctx``, in
    the layout of ``inputs`` (row ``inverse_perm[g]`` is global token g)."""
    from v2pe_tpu_torch.models.internvl_chat import forward
    from v2pe_tpu_torch.parallel import context as pctx

    t = lambda a: torch.as_tensor(np.asarray(a)).cuda()
    with torch.inference_mode(), pctx.use_sharding(ctx):
        return forward(
            model, cfg, input_ids=t(inputs["input_ids"]).long(),
            pixel_values=t(pixels), image_flags=t(flags),
            rope_pos_ids=t(inputs["rope_pos_ids"]),
            img_context_token_id=92546,
            segment_ids=t(inputs["segment_ids"]),
            token_positions=t(inputs["token_positions"]),
            vit_gather_idx=t(idx)).logits[0]


def logit_distance(a, b, n_rows: int, span) -> tuple:
    """(max|a - b| over the first ``n_rows`` global rows / max|b| there,
    max|a - b| at the answer rows, b's answer rows), ``a`` and ``b`` being
    (logits, inverse permutation) of two runs; 4096 rows at a time, so no
    second (S, V) buffer is made."""
    (la, ia), (lb, ib) = a, b
    d = m = 0.0
    for r0 in range(0, n_rows, 4096):
        xb = lb[ib[r0:min(r0 + 4096, n_rows)]]
        d = max(d, (la[ia[r0:min(r0 + 4096, n_rows)]] - xb).abs().max()
                .item())
        m = max(m, xb.abs().max().item())
    rows = slice(span[0] - 1, span[1] - 1)
    rows_b = lb[ib[rows]]
    return d / m, (la[ia[rows]] - rows_b).abs().max().item(), rows_b


def same_or_tied(pred, rows_ref, dist: float) -> tuple:
    """(how many of ``pred`` are the argmax of the reference rows, whether
    every other one is a token whose reference logit is within 2 * dist of
    the row's top: a near tie that a distance of ``dist`` can turn)."""
    top = rows_ref.max(dim=-1).values
    chosen = rows_ref.gather(1, torch.as_tensor(
        pred, device=rows_ref.device)[:, None])[:, 0]
    return int((chosen == top).sum()), bool((chosen >= top - 2 * dist).all())


def phase_ring_eval(model, cfg) -> dict:
    """The MM-NIAH-long teacher-forced eval at full width: one 32,768-token
    prompt with 32 tiles through ``teacher_forced_eval``, unsharded and
    under ``ShardingContext(seq_shards=4)`` with the scan and the fused
    ring. The fused run launches the fused kernel once a layer and the
    flash forward for the ViT only. A second forward of each run (launches
    not counted) gives its logits. In bf16 any two paths through the 24
    layers end about 3e-2 of the logits' range apart, whatever they differ
    in (the fused ring from the scan ring as far as either from unsharded,
    or the paged cache from the dense one), so there the logits are held
    within LOGIT_TOL and an answer token may differ where the reference's
    top logits are closer than the paths. The exact check is the same
    eval with the same weights in fp32, where the kernels differ by
    summation order only: logits within LOGIT_TOL_FP32 of the unsharded
    run's, every answer token identical, the same launches."""
    import copy

    from v2pe_tpu_torch.evalkit import mm_niah_long as niah
    from v2pe_tpu_torch.parallel import context as pctx

    ids, span, pos, pixels, gather = needle_prompt(
        cfg, RING_EVAL_TOKENS, RING_EVAL_TILES)
    flags = np.ones(RING_EVAL_TILES, np.int32)
    L, Lv = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers
    n_ans = span[1] - span[0]
    answer = slice(span[0] - 1, span[1] - 1)
    model.eval()

    def launches_ok(tag, c):
        if tag == "fused":
            return c["ring_fused_fwd"] == L and c["flash_fwd"] == Lv
        return c["ring_fused_fwd"] == 0 and (
            c["flash_fwd"] == Lv + L if tag == "unsharded"
            else Lv < c["flash_fwd"] <= Lv + L * RING_SHARDS ** 2)

    runs = {}
    for dtype, tol in ((torch.bfloat16, LOGIT_TOL),
                       (torch.float32, LOGIT_TOL_FP32)):
        exact = dtype == torch.float32
        m = copy.deepcopy(model).float() if exact else model
        kind = "fp32" if exact else "bf16"
        for tag, shards, mode in (("unsharded", 1, "scan"),
                                  ("scan", RING_SHARDS, "scan"),
                                  ("fused", RING_SHARDS, "fused")):
            inputs = niah.build_teacher_forced_inputs(ids, span, pos,
                                                      seq_shards=shards)
            perm = np.argsort(inputs["inverse_perm"])
            idx = gather[perm][None]
            ctx = pctx.ShardingContext(seq_shards=shards, ring_mode=mode)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with pctx.use_sharding(ctx):
                pred = niah.teacher_forced_eval(
                    m, cfg, inputs, pixels, flags, 92546, vit_gather_idx=idx)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_launches()
            logits = eval_logits(m, cfg, inputs, pixels, flags, idx, ctx)
            inv = torch.as_tensor(inputs["inverse_perm"]).cuda()
            finite = bool(torch.isfinite(logits).all())
            again = logits[inv[answer]].argmax(-1).cpu().numpy()
            runs[tag] = dict(pred=pred, s=dt, counts=counts,
                             logits=(logits, inv))
            del logits
            rel, dist, rows = logit_distance(
                runs[tag]["logits"], runs["unsharded"]["logits"], len(ids),
                span)
            equal, tied = same_or_tied(pred, rows, dist)
            log(f"ring eval ({tag}, {kind}): {RING_EVAL_TOKENS} tokens, "
                f"{RING_EVAL_TILES} tiles, seq_shards {shards}: {dt:.2f} s = "
                f"{RING_EVAL_TOKENS / dt:.0f} tok/s; answer predictions "
                f"{pred.tolist()}: {equal} of {n_ans} the unsharded run's, "
                f"the others within the paths' distance at the answer rows "
                f"{tied} (max|dlogit| there {dist:.3e}); logits finite "
                f"{finite}, max|dlogit|/max|logit| against unsharded "
                f"{rel:.3e} (tol {tol}); launches flash_fwd "
                f"{counts['flash_fwd']}, ring_fused_fwd "
                f"{counts['ring_fused_fwd']}")
            if not finite or rel > tol or not tied \
                    or not np.array_equal(pred, again) \
                    or (exact and equal != n_ans):
                raise AssertionError(
                    f"ring eval ({tag}, {kind}): logits malformed or far "
                    f"from the unsharded run, or other answer tokens")
            if not launches_ok(tag, counts):
                raise AssertionError(f"ring eval ({tag}, {kind}): launches "
                                     f"are not one fused launch a layer")
            if exact and tag != "unsharded":
                del runs[tag]["logits"]  # room for the next run
        # the fused ring against the scan ring
        if not exact:
            rel, dist, rows = logit_distance(
                runs["fused"]["logits"], runs["scan"]["logits"], len(ids),
                span)
            equal, tied = same_or_tied(runs["fused"]["pred"], rows, dist)
            log(f"ring eval (bf16): fused against scan max|dlogit|/"
                f"max|logit| {rel:.3e} (tol {tol}), at the answer rows "
                f"max|dlogit| {dist:.3e}; {equal} of {n_ans} answer tokens "
                f"the scan ring's, the others within that distance of its "
                f"top {tied}")
            if rel > tol or not tied:
                raise AssertionError("ring eval: the fused ring is far from "
                                     "the scan ring")
            fused_counts = runs["fused"]["counts"]
        log(f"ring eval ({kind}): seconds unsharded "
            f"{runs['unsharded']['s']:.2f} scan {runs['scan']['s']:.2f} "
            f"fused {runs['fused']['s']:.2f}")
        del rows, m
        runs.clear()
        torch.cuda.empty_cache()
    return fused_counts


RING_TRAIN_TOL = {"loss": 1e-2, "grad_norm": 5e-2}  # relative, bf16: the
# ring rotates q outside the kernel (rounded to bf16) and sums each
# gradient over 16 (rank, chunk) rectangles


def phase_ring_train(model, cfg) -> dict:
    """Two steps of ``make_train_step`` under ``MeshConfig(seq=4)`` with the
    fused ring on make_synthetic_batch's 8192 tokens + 8 tiles
    (zigzag-permuted; remat 'full', int8 Adam, lr 1e-5, warmup 1), held
    against one unsharded step on the same batch in global order. The first
    step of a run has learning rate 0 (warmup 1), so the ring's and the
    unsharded run's first steps see the same weights. Launches a step: the
    fused forward twice a decoder layer (remat), the flash forward twice a
    ViT layer, each backward kernel once a ViT layer and once a live
    (rank, chunk) pair of a decoder layer."""
    from v2pe_tpu_torch import config
    from v2pe_tpu_torch.parallel import ring
    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID, make_synthetic_batch
    from v2pe_tpu_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device

    def setup(shards):
        opt = build_optimizer(train_config(), model, cfg)
        mesh = config.MeshConfig(seq=shards) if shards > 1 else None
        step = make_train_step(cfg, opt, mesh, IMG_CONTEXT_ID, remat="full",
                               ring_mode="fused")
        batch = make_synthetic_batch(cfg, 1, TRAIN_TOKENS,
                                     tiles_per_row=TRAIN_TILES, stride=64,
                                     seq_shards=shards)
        return step, opt.init(), {k: torch.as_tensor(v).to(dev)
                                  for k, v in batch.items()}

    def run(step, state, batch, tag):
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, gnorm = step(model, state, batch)
        loss, gnorm = loss.item(), gnorm.item()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"ring train step ({tag}): loss {loss:.4f} grad_norm "
            f"{gnorm:.4f} {ms:.1f} ms {TRAIN_TOKENS / ms * 1e3:.0f} tok/s, "
            f"peak {peak:.2f} GiB allocated; "
            f"launches { {k: v for k, v in counts.items() if v} }")
        return loss, gnorm, counts

    model.train()
    ring_step, ring_state, ring_batch = setup(RING_SHARDS)
    plain_step, plain_state, plain_batch = setup(1)
    seg, pos = ring_batch["segment_ids"], ring_batch["token_positions"]
    live = int((ring.branch_table(ring.RingStatics(True, 1.0), RING_SHARDS,
                                  seg, seg, pos, pos) != 0).sum())
    l_r, g_r, c1 = run(ring_step, ring_state, ring_batch,
                       "seq=4 fused, step 1, lr 0")
    l_p, g_p, _ = run(plain_step, plain_state, plain_batch,
                      "unsharded, step 1, lr 0")
    l_2, g_2, c2 = run(ring_step, ring_state, ring_batch,
                       "seq=4 fused, step 2")
    model.eval()
    d_loss, d_gn = abs(l_r - l_p) / abs(l_p), abs(g_r - g_p) / abs(g_p)
    L, Lv = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers
    want = {"ring_fused_fwd": 2 * L, "flash_fwd": 2 * Lv,
            "flash_bwd_dkv": Lv + L * live, "flash_bwd_dq": Lv + L * live}
    log(f"ring train: seq=4 fused against unsharded on the same weights: "
        f"loss rel {d_loss:.2e} (tol {RING_TRAIN_TOL['loss']}), grad_norm "
        f"rel {d_gn:.2e} (tol {RING_TRAIN_TOL['grad_norm']}); {live} live "
        f"(rank, chunk) pairs a layer; launches a step expected {want}")
    ok = all(np.isfinite(x) for x in (l_r, g_r, l_2, g_2)) \
        and d_loss <= RING_TRAIN_TOL["loss"] \
        and d_gn <= RING_TRAIN_TOL["grad_norm"] \
        and all(c[k] == v for c in (c1, c2) for k, v in want.items())
    if not ok:
        raise AssertionError("ring train steps disagree with the unsharded "
                             "step, or their launches are not as designed")
    return {k: c1[k] + c2[k] for k in c1}


# ---------------------------------------------------------------- profile


# ------------------------- phases 16-19: LoRA, compress-seq, seq-cls, utils


LORA_LLM_R, LORA_VIT_R = 16, 8  # --use_llm_lora, --use_backbone_lora
LORA_STEPS = 3
SEQ_CLS_LENGTHS = (2048, 1500, 777, 2040)  # right-padded to 2048
SEQ_CLS_PAD = 2


def small_slice_cfg(**kw):
    """The 2-layer fp32 model of the small train reference."""
    from v2pe_tpu_torch import config

    return config.VLMConfig(
        vision=config.VisionConfig(hidden_size=128, intermediate_size=256,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   image_size=112, patch_size=14),
        llm=config.LLMConfig(vocab_size=1000, hidden_size=256,
                             intermediate_size=512, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2, **kw)


def _step_result(res: dict, devices, what: str, lr: float) -> None:
    """Card against CPU for one small step: ``res[dev]`` = (loss, grad norm,
    gradients, updated tensors). Limits as in the small train reference:
    loss, grad norm and gradients within 1e-4 of their range, updated
    tensors within 1e-4 of their range plus 1% of one step."""
    (l_c, g_c, d_c, p_c), (l_g, g_g, d_g, p_g) = (res[d] for d in devices)
    d_loss, d_gn = abs(l_g - l_c) / abs(l_c), abs(g_g - g_c) / abs(g_c)
    d_grad = _max_rel(d_g, d_c)
    d_par = max(((p_g[n] - p_c[n]).abs().max() / (
        1e-4 * p_c[n].abs().max() + 1e-2 * lr)).item() for n in p_c)
    log(f"reference: {what}, card vs CPU: loss {l_g:.6f} vs {l_c:.6f} (rel "
        f"{d_loss:.2e}), grad_norm {g_g:.6f} vs {g_c:.6f} (rel {d_gn:.2e}), "
        f"{len(d_c)} gradients max|d|/range {d_grad:.2e} (tol 1e-4); "
        f"{len(p_c)} updated tensors max|d| at {d_par:.2f} of the tolerance")
    if max(d_loss, d_gn, d_grad) > 1e-4 or d_par > 1.0:
        raise AssertionError(f"card and CPU disagree: {what}")


def phase_small_slice_reference(devices=("cpu", "cuda")) -> None:
    """The 2-layer fp32 model on the card (the kernels) against the CPU
    (the plain versions): one LoRA train step (adapters of both towers, B
    drawn nonzero), one compress-seq train step with each fuse method
    (4 chunks of the 300-token packed row, LayerScale 0.1), and the
    sequence-classification head's pooled logits, loss and gradients. A
    step is make_train_step's update with its gradients kept: one forward
    and backward, then the optimizer."""
    import copy

    from v2pe_tpu_torch.models.compress_seq import init_compress_params
    from v2pe_tpu_torch.models.lora import build_lora, lora_view
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.models.sequence_classification import (
        init_seq_cls_params, seq_cls_forward)
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer
    from v2pe_tpu_torch.train.train_step import loss_fn

    cfg = small_slice_cfg()
    tc = TrainConfig(learning_rate=1e-5, warmup_steps=0, total_steps=10,
                     use_8bit_optimizer=True)
    base = init_vlm_params(cfg, torch.Generator().manual_seed(21))
    lora0 = build_lora(torch.Generator().manual_seed(3), base, backbone_r=4,
                       llm_r=8)
    with torch.no_grad():
        g = torch.Generator().manual_seed(4)
        for ad in lora0.targets().values():
            ad.B.copy_(torch.randn(ad.B.shape, generator=g) * 0.02)

    def grads_of(module):
        return {n: p.grad.cpu() for n, p in module.named_parameters()
                if p.grad is not None}

    def step(trained, forward_model, cfg_, dev):
        """make_train_step's update, with the gradients kept: (loss, grad
        norm, gradients, updated tensors) on the CPU."""
        loss = loss_fn(forward_model, cfg_, small_train_batch(cfg_, dev), 999,
                       remat="full")
        loss.backward()
        grads = grads_of(trained)
        opt = build_optimizer(tc, trained, cfg_)
        gnorm = opt.step({n: p.grad for n, p in trained.named_parameters()},
                         opt.init())
        return (loss.item(), gnorm.item(), grads, {
            n: p.detach().cpu() for n, p in trained.named_parameters()})

    res = {}
    for dev in devices:
        model, lora = copy.deepcopy(base).to(dev), copy.deepcopy(lora0).to(dev)
        res[dev] = step(lora, lora_view(model, lora), cfg, dev)
    _step_result(res, devices, "small LoRA train step fp32 (int8 Adam)",
                 tc.learning_rate)

    for fuse in ("add", "cross-attn"):
        cfg_c = dataclasses.replace(cfg, compress_seq=True, fuse_method=fuse,
                                    chunk_num=COMPRESS_CHUNKS)
        res = {}
        for dev in devices:
            model = copy.deepcopy(base).to(dev)
            model.compress = init_compress_params(model.llm, 0.1, cfg.llm,
                                                  fuse)
            res[dev] = step(model, model, cfg_c, dev)
        _step_result(res, devices, f"small compress-seq train step fp32 "
                     f"({fuse}, int8 Adam)", tc.learning_rate)

    cls0 = init_seq_cls_params(torch.Generator().manual_seed(5), cfg.llm, 3)
    rng = np.random.default_rng(6)
    ids = rng.integers(3, 1000, (4, 64))
    for b, n in enumerate((64, 50, 17, 63)):
        ids[b, n:] = SEQ_CLS_PAD
    out = {}
    for dev in devices:
        cls = copy.deepcopy(cls0).to(dev)
        t = torch.as_tensor(ids, device=dev)
        pooled, loss = seq_cls_forward(
            cls, cfg.llm, input_ids=t, pad_token_id=SEQ_CLS_PAD,
            segment_ids=(t != SEQ_CLS_PAD).int(),
            labels=torch.tensor([0, 2, 1, 1], device=dev))
        loss.backward()
        out[dev] = (pooled.detach().cpu(), loss.item(), grads_of(cls))
    (p_c, l_c, d_c), (p_g, l_g, d_g) = (out[d] for d in devices)
    d_p = _rel(p_g, p_c)
    d_l = abs(l_g - l_c) / abs(l_c)
    d_grad = _max_rel(d_g, d_c)
    log(f"reference: small seq-cls fp32, card vs CPU: pooled logits "
        f"max|d|/range {d_p:.2e}, loss rel {d_l:.2e}, {len(d_c)} gradients "
        f"max|d|/range {d_grad:.2e} (tol 1e-4)")
    if max(d_p, d_l, d_grad) > 1e-4:
        raise AssertionError("card and CPU disagree: seq-cls")


def phase_lora_train(model, cfg, device: str = "cuda") -> tuple:
    """Three steps of InternVL2-2B LoRA training through trainer.train
    (use_llm_lora=16, use_backbone_lora=8) on 8192 packed tokens and 8
    tiles (remat 'full', int8 Adam, lr 1e-5, warmup 1), then its
    asynchronous checkpoint: per-step loss, grad norm, rate and launches
    (96 / 48 / 48, as phase 9: the adapters change the weights, not the
    attention), the checkpoint's size against the base's, peak memory; the
    base weights bit for bit unchanged, every A and B moved, alpha 2r.
    Returns (launch counts, the merged model train returned, the adapters
    read back from the checkpoint, the base's state before)."""
    import tempfile

    from v2pe_tpu_torch.core import checkpoint as ckpt
    from v2pe_tpu_torch.models.lora import build_lora, lora_from_state_dict
    from v2pe_tpu_torch.train.trainer import RunConfig, train

    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    steps, marks = [], {}
    tc = dataclasses.replace(train_config(), total_steps=LORA_STEPS)
    model.train()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        run = RunConfig(output_dir=tmp, max_steps=LORA_STEPS,
                        save_steps=LORA_STEPS, log_steps=1,
                        max_packed_tokens=TRAIN_TOKENS, max_tiles=TRAIN_TILES)
        reset_launches()
        merged, _, _ = train(cfg, model, train_packer(cfg), run, tc,
                             img_context_token_id=92546, remat="full",
                             resume=False, metrics_hook=_step_hook(steps,
                                                                   marks),
                             use_llm_lora=LORA_LLM_R,
                             use_backbone_lora=LORA_VIT_R)
        counts = read_launches()
        save_s = time.perf_counter() - marks["t"]
        path = ckpt.latest_checkpoint(tmp)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        sd = torch.load(os.path.join(path, "params.pt"), map_location=device)
        moments = torch.load(os.path.join(path, "opt_state.pt"))["moments"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.eval()
    merged.eval()
    base_bytes = sum(v.numel() * v.element_size() for v in before.values())
    for i, m in enumerate(steps):
        ms = TRAIN_TOKENS / m["tokens_per_sec"] * 1e3
        log(f"lora train step {i + 1}: loss {m['loss']:.4f} grad_norm "
            f"{m['grad_norm']:.4f} {ms:.1f} ms {m['tokens_per_sec']:.0f} "
            f"tok/s; launches {m['launches']}")
    rates = sorted(m["tokens_per_sec"] for m in steps[1:])
    med = rates[len(rates) // 2]
    lora = lora_from_state_dict(sd, device=device)
    n_adapter = sum(p.numel() for p in lora.parameters())
    log(f"lora train: {LORA_STEPS} steps of {TRAIN_TOKENS} tokens x "
        f"{TRAIN_TILES} tiles, ranks llm {LORA_LLM_R} / vit {LORA_VIT_R} "
        f"({len(lora.targets())} adapters, {n_adapter / 1e6:.2f}M trained "
        f"values; remat full, int8 Adam): median of steps 2-{LORA_STEPS} "
        f"{med:.0f} tok/s = {TRAIN_TOKENS / med * 1e3:.1f} ms a step; peak "
        f"{peak:.2f} GiB allocated; async save + commit {save_s:.2f}s, "
        f"{size / 2 ** 20:.2f} MiB (adapters and their optimizer state) "
        f"against the base's {base_bytes / 2 ** 30:.2f} GiB ({card_line()})")
    check_train_steps(cfg, steps, LORA_STEPS, "lora train")
    after = model.state_dict()
    differ = [k for k in before if not same_bits(before[k], after[k])]
    start = build_lora(torch.Generator(device).manual_seed(run.seed ^ 0x10BA),
                       model, backbone_r=LORA_VIT_R, llm_r=LORA_LLM_R)
    s0 = start.state_dict()
    still = [k for k in s0 if not k.endswith(".alpha")
             and torch.equal(s0[k], sd[k])]
    alphas = {k: float(v) for k, v in sd.items() if k.endswith(".alpha")}
    bad_alpha = [k for k, a in alphas.items()
                 if a != 2.0 * (LORA_VIT_R if k.startswith("vision")
                                else LORA_LLM_R)]
    keys = set(moments)
    log(f"lora train: base tensors changed {len(differ)}/{len(before)}; "
        f"adapter tensors unmoved {len(still)}/{2 * len(lora.targets())}; "
        f"alpha off 2r {len(bad_alpha)}; checkpoint tensors "
        f"{len(sd)} (A, B, alpha), optimizer leaves {sorted(keys)[:2]}...")
    if differ or still or bad_alpha or not all(
            k.endswith(("/a", "/b")) for k in keys):
        raise AssertionError(f"lora train: base changed {differ[:3]}, "
                             f"unmoved {still[:3]}, alpha {bad_alpha[:3]}")
    return counts, merged, lora, before


def phase_lora_utils(model, cfg, lora, device: str = "cuda") -> None:
    """``utils/``: two LoRA steps of a copy of the trained adapters
    (make_train_step on the bench recipe's batch) timed by StepTimer, the
    second inside profile_trace, whose Chrome trace must name the flash
    forward and both backward kernels; nan_guard silent on the loss and
    logging an injected inf once; assert_finite passing the adapters and
    raising on the inf."""
    import copy
    import logging
    import tempfile

    from v2pe_tpu_torch.train.optimizer import build_optimizer
    from v2pe_tpu_torch.train.synth import IMG_CONTEXT_ID, make_synthetic_batch
    from v2pe_tpu_torch.train.train_step import make_train_step
    from v2pe_tpu_torch.utils import diagnostics
    from v2pe_tpu_torch.utils.profiling import (StepTimer, profile_trace,
                                                step_marker)

    ad = copy.deepcopy(lora)
    opt = build_optimizer(train_config(), ad, cfg)
    state = opt.init()
    step = make_train_step(cfg, opt, img_context_token_id=IMG_CONTEXT_ID,
                           remat="full", lora=True)
    batch = {k: torch.as_tensor(v).to(device) for k, v in make_synthetic_batch(
        cfg, 1, TRAIN_TOKENS, tiles_per_row=TRAIN_TILES, stride=64).items()}
    timer = StepTimer()
    timer.tick()
    model.train()
    loss, _ = step(ad, state, batch, model)
    torch.cuda.synchronize()
    first = timer.tick(TRAIN_TOKENS)
    for attempt in range(3):  # the profiler, at times, hands back the
        # runtime calls alone: such a trace is taken again, at most twice
        with tempfile.TemporaryDirectory() as tmp:
            with profile_trace(tmp):
                with step_marker("lora_step"):
                    loss, _ = step(ad, state, batch, model)
            second = timer.tick(TRAIN_TOKENS)
            (trace,) = [os.path.join(tmp, f) for f in os.listdir(tmp)]
            trace_mb = os.path.getsize(trace) / 2 ** 20
            with open(trace) as f:
                names = {e.get("name", "")
                         for e in json.load(f)["traceEvents"]}
        found = {k: any(k in n for n in names) for k in
                 ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "lora_step")}
        if all(found.values()):
            break
        log(f"    the trace named {found} (attempt {attempt + 1})")
    model.eval()
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(diagnostics.__name__)
    handler = Keep(level=logging.ERROR)
    logger.addHandler(handler)
    try:
        diagnostics.nan_guard(loss, "loss")
        quiet = not records
        bad = ad.targets()["llm.layers.0.wqkv"].B.detach().clone()
        bad[0, 0] = float("inf")
        diagnostics.nan_guard(bad, "injected")
    finally:
        logger.removeHandler(handler)
    diagnostics.assert_finite(ad, "adapters")
    try:
        diagnostics.assert_finite({"adapters": ad, "bad": [bad]}, "tree")
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    log(f"utils: StepTimer {first['step_time_last'] * 1e3:.1f} ms then "
        f"{second['step_time_last'] * 1e3:.1f} ms profiled "
        f"({second['tokens_per_sec']:.0f} tok/s over the window); "
        f"profile_trace wrote {trace_mb:.1f} MiB naming {found}; nan_guard "
        f"quiet on a finite loss {quiet}, on the inf {records}; "
        f"assert_finite: {raised}")
    if not (all(found.values()) and quiet and len(records) == 1
            and "injected" in records[0] and raised
            and "tree:bad/[0]" in raised and first and second):
        raise AssertionError("utils checks failed")


def phase_lora_serve(model, cfg, tok, served: dict, merged, lora,
                     before: dict, device: str = "cuda") -> list:
    """ChatModel(base, lora=fresh adapters with B = 0) answers phase 3's
    requests with the base model's answers (the merge of a zero delta is
    exact); ChatModel(base, lora=the trained adapters) gives the 8-tile
    request's first logits of the merged model train returned, bit for
    bit; export_torch_state_dict(base, lora=...) equals the merged model's
    export tensor for tensor; the base model is unchanged afterwards.
    Returns the launch counts of the fresh-adapter requests."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.models.export import export_torch_state_dict
    from v2pe_tpu_torch.models.lora import build_lora

    fresh = build_lora(torch.Generator(device).manual_seed(1), model,
                       backbone_r=LORA_VIT_R, llm_r=LORA_LLM_R)
    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    answers = ChatModel(model, cfg, tok, lora=fresh).batch_chat(
        _request_pixels(), [q for _, q in REQUESTS], gc)
    counts = read_launches()
    wall = time.perf_counter() - t0
    require(counts, ("flash_fwd",), "lora serve")
    equal = answers == served["answers"]
    n, q = REQUESTS[0]
    chat = ChatModel(model, cfg, tok, lora=lora)
    ids, pos, _ = chat.encode_chat(q, [n])
    pixels = _tiles(n, 0)
    got = first_logits(chat, cfg, ids, pos, pixels, [], "dense", steps=0)
    want = first_logits(ChatModel(merged, cfg, tok), cfg, ids, pos, pixels,
                        [], "dense", steps=0)
    plain = first_logits(ChatModel(model, cfg, tok), cfg, ids, pos, pixels,
                         [], "dense", steps=0)
    del chat
    a = export_torch_state_dict(model, cfg, lora=lora)
    b = export_torch_state_dict(merged, cfg)
    differ = sorted(k for k in b if k not in a or not same_bits(a[k], b[k]))
    del a, b
    after = model.state_dict()
    changed = [k for k in before if not same_bits(before[k], after[k])]
    log(f"lora serve: 3 requests with fresh adapters (B = 0) in {wall:.3f}s,"
        f" flash launches {counts['flash_fwd']}, answers equal to the base "
        f"model's {equal}; trained adapters: first logits equal to train's "
        f"merged model bit for bit {same_bits(got, want)} (max|d| from the "
        f"base's {(got - plain).abs().max().item():.3e}); export with lora= "
        f"against the merged model's: {len(differ)} tensors differ; base "
        f"tensors changed {len(changed)}")
    if not (equal and same_bits(got, want) and not differ and not changed):
        raise AssertionError("lora serve checks failed")
    return [counts]


def check_compress_steps(cfg, steps: list, where: str) -> None:
    """Finite losses and grad norms; launches a step: the ViT's forward
    twice a layer (remat) and the decoder's twice a layer (the interaction
    and the within-chunk attention, no remat), the backward kernels once a
    ViT layer and twice a decoder layer."""
    Lv, Ll = cfg.vision.num_hidden_layers, cfg.llm.num_hidden_layers
    want = {"flash_fwd": 2 * Lv + 2 * Ll, "flash_bwd_dkv": Lv + 2 * Ll,
            "flash_bwd_dq": Lv + 2 * Ll}
    ok = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
             and all(m["launches"][k] == v for k, v in want.items())
             for m in steps)
    if not ok:
        raise AssertionError(f"{where}: expected finite losses and {want} "
                             f"launches a step")


def phase_compress_train(model, cfg) -> list:
    """For each fuse method ('add', 'cross-attn'): the compress-seq module
    built from the decoder (``init_compress_params``), then three steps of
    make_train_step on the bench recipe's batch (8192 tokens, 8 tiles,
    chunk_num 4: four chunks of 2048 tokens, 400 summary tokens) through
    ``internvl_chat.forward``'s compress route: loss, grad norm, time,
    launches a step (check_compress_steps), peak memory, and
    ``compress.layer_scale`` moved. The module is removed afterwards."""
    from v2pe_tpu_torch.models.compress_seq import init_compress_params

    paths = []
    for fuse in ("add", "cross-attn"):
        cfg_c = dataclasses.replace(cfg, compress_seq=True, fuse_method=fuse,
                                    chunk_num=COMPRESS_CHUNKS)
        model.compress = init_compress_params(model.llm, cfg=cfg.llm,
                                              fuse_method=fuse)
        ls0 = model.compress.layer_scale.detach().clone()
        step, state, batch = bench_recipe(model, cfg_c)
        model.train()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps = timed_steps(f"compress train ({fuse})", step, model, state,
                            batch)
        paths.append(read_launches())
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        model.eval()
        moved = not torch.equal(model.compress.layer_scale, ls0)
        ms = sorted(m["ms"] for m in steps[1:])[len(steps[1:]) // 2]
        log(f"compress train ({fuse}): {TRAIN_TOKENS} tokens x {TRAIN_TILES} "
            f"tiles in {COMPRESS_CHUNKS} chunks (ViT remat full, decoder not "
            f"rematerialized, int8 Adam): median of steps 2-{BENCH_STEPS} "
            f"{ms:.1f} ms = {TRAIN_TOKENS / ms * 1e3:.0f} tok/s; peak "
            f"{peak:.2f} GiB allocated; layer_scale moved {moved} "
            f"({card_line()})")
        check_compress_steps(cfg, steps, f"compress train ({fuse})")
        if not moved:
            raise AssertionError(f"compress train ({fuse}): layer_scale did "
                                 f"not move")
        del model.compress, step, state, batch
        torch.cuda.empty_cache()
    return paths


def phase_compress_fuse_only(model, cfg, device: str = "cuda") -> dict:
    """One 8192-token forward of compress_fuse_only_forward in 4 chunks
    (cross-attn fuse over compress2 summaries of the earlier chunks):
    finite fp32 logits of the full vocabulary, and one flash launch a
    decoder layer (the chunk loop's fuse is plain torch)."""
    from v2pe_tpu_torch.models.compress_seq import (compress_fuse_only_forward,
                                                    init_compress_params)

    compress = init_compress_params(model.llm, cfg=cfg.llm,
                                    fuse_method="cross-attn")
    g = torch.Generator(device).manual_seed(7)
    ids = torch.randint(3, 20000, (1, TRAIN_TOKENS), generator=g,
                        device=device)
    pos = torch.arange(TRAIN_TOKENS, dtype=torch.float32,
                       device=device)[None]
    with torch.inference_mode():
        embeds = model.llm.tok_embeddings(ids)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        logits = compress_fuse_only_forward(model.llm, compress, cfg.llm,
                                            embeds, pos, COMPRESS_CHUNKS)
        counts = read_launches()
        secs = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
    del logits, compress
    torch.cuda.empty_cache()
    want = cfg.llm.num_hidden_layers
    log(f"compress fuse-only: {TRAIN_TOKENS} tokens in {COMPRESS_CHUNKS} "
        f"chunks in {secs * 1e3:.1f} ms, logits {shape} finite {finite}; "
        f"flash launches {counts['flash_fwd']} (one a layer, the chunk "
        f"loop's fuse none: {want})")
    if not finite or counts["flash_fwd"] != want:
        raise AssertionError("compress fuse-only checks failed")
    return counts


def phase_seq_cls(model, cfg, device: str = "cuda") -> dict:
    """The sequence-classification head on the decoder's layers (shared,
    with a seeded bf16 ``score`` of 3 labels): 4 right-padded rows of up to
    2048 tokens in one forward, one flash launch a layer; pooled logits
    finite, equal to the full logits at the pooled index; the pooled index
    equal to pool_last_token's on the host; each of the three losses
    finite."""
    from torch import nn

    from v2pe_tpu_torch.models.internlm2 import llm_forward
    from v2pe_tpu_torch.models.sequence_classification import (
        InternLM2ForSequenceClassification, pool_last_token, seq_cls_forward)

    cls = InternLM2ForSequenceClassification.__new__(
        InternLM2ForSequenceClassification)
    nn.Module.__init__(cls)
    cls.tok_embeddings, cls.layers = model.llm.tok_embeddings, \
        model.llm.layers
    cls.norm = model.llm.norm
    g = torch.Generator(device).manual_seed(8)
    cls.score = nn.Linear(cfg.llm.hidden_size, 3, bias=False, device=device,
                          dtype=model.llm.norm.dtype)
    with torch.no_grad():
        cls.score.weight.normal_(0.0, 0.02, generator=g)
    S = max(SEQ_CLS_LENGTHS)
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 20000, (len(SEQ_CLS_LENGTHS), S))
    for b, n in enumerate(SEQ_CLS_LENGTHS):
        ids[b, n:] = SEQ_CLS_PAD
    t = torch.as_tensor(ids, device=device)
    seg = (t != SEQ_CLS_PAD).int()
    kw = dict(input_ids=t, pad_token_id=SEQ_CLS_PAD, segment_ids=seg)
    B = len(SEQ_CLS_LENGTHS)
    labels = {"single_label_classification": torch.tensor(
        [0, 2, 1, 1], device=device),
        "multi_label_classification": torch.tensor(
            rng.integers(0, 2, (B, 3)), dtype=torch.float32, device=device),
        "regression": torch.tensor(rng.standard_normal((B, 3)),
                                   dtype=torch.float32, device=device)}
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pooled, _ = seq_cls_forward(cls, cfg.llm, **kw)
        counts = read_launches()
        ms = (time.perf_counter() - t0) * 1e3
        losses = {pt: float(seq_cls_forward(cls, cfg.llm, labels=lb,
                                            problem_type=pt, **kw)[1])
                  for pt, lb in labels.items()}
        hidden, _ = llm_forward(cls, cfg.llm, input_ids=t, segment_ids=seg,
                                return_hidden=True)
        full = hidden.float() @ cls.score.weight.float().t()
        ar = torch.arange(S)[None, :, None].expand(B, S, 1)
        host = pool_last_token(ar, torch.as_tensor(ids), SEQ_CLS_PAD)[:, 0]
        card = pool_last_token(ar.to(device), t, SEQ_CLS_PAD)[:, 0].cpu()
        at = full[torch.arange(B), host.to(device)]
    log(f"seq-cls: {B} rows of {list(SEQ_CLS_LENGTHS)} tokens padded to {S} "
        f"in {ms:.1f} ms, flash launches {counts['flash_fwd']}; pooled index"
        f" {card.tolist()} (host {host.tolist()}); pooled logits finite "
        f"{bool(torch.isfinite(pooled).all())}, equal to the full logits "
        f"there {same_bits(pooled, at)}; losses {losses}")
    if not (torch.equal(host, card)
            and host.tolist() == [n - 1 for n in SEQ_CLS_LENGTHS] and bool(torch.isfinite(pooled).all()) and same_bits(pooled, at)
            and all(np.isfinite(v) for v in losses.values())
            and counts["flash_fwd"] == cfg.llm.num_hidden_layers):
        raise AssertionError("seq-cls checks failed")
    return counts


def profile_generate(chat, cfg) -> None:
    """``--profile``: the 8-tile request through generate (bf16 weights:
    dense, paged bf16, paged int8 pool; int8 weights: dense and paged int8
    pool; int4 weights: dense; the first token alone, then 32 tokens) under
    torch.profiler: wall, device time (the kernel events' sum), busy share,
    kernels launched, and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate

    tiles, question = REQUESTS[0]
    ids, pos, _ = chat.encode_chat(question, [tiles])
    args = (torch.as_tensor(ids[None]), torch.tensor([len(ids)]),
            torch.as_tensor(pos[None]), torch.as_tensor(_tiles(tiles, 0)),
            torch.ones(tiles, dtype=torch.int32), chat.img_context_token_id)
    stop = tuple(chat.conv_template.stop_token_ids)
    models = {None: chat.model}
    for wd, mode, kv in ((None, "dense", None), (None, "paged", None),
                         (None, "paged", "int8"), ("int8", "dense", None),
                         ("int8", "paged", "int8"), ("int4", "dense", None)):
        if wd not in models:
            models[wd] = ChatModel(chat.model, cfg, chat.tokenizer,
                                   weights_dtype=wd).model
        model = models[wd]
        for n in (1, MAX_NEW):
            gc = GenerationConfig(max_new_tokens=n, eos_token_ids=stop)
            run = lambda: generate(model, cfg, gc, *args, cache_mode=mode,
                                   kv_dtype=kv)
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
            log(f"profile {wd or 'bf16'} weights, {mode} {kv or 'bf16'}, "
                f"{int(lens[0])} tokens: wall {wall:.1f} ms, device "
                f"{dev:.1f} ms ({dev / wall:.0%} busy), "
                f"{sum(e.count for e in ev)} kernels")
            for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<6}"
                    f" {e.key[:80]}")


def profile_engine_block(chat, cfg) -> None:
    """``--profile``, second part: one decode block of the engine (64 steps
    over 8 rows of 8192-token prompts, the bench recipe) under
    torch.profiler: wall, device time, busy share, kernels a step, and the
    top kernels by device time; for a bf16 and an int4 pool."""
    from torch.profiler import ProfilerActivity, profile

    for kv in (None, "int4"):
        eng = engine_recipe(chat, cfg, kv_dtype=kv)
        _engine_submit(eng, cfg, np.random.default_rng(0), ENGINE_ROWS,
                       ENGINE_NEW)
        eng.step()  # the admissions and a first block
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(e.self_device_time_total for e in ev) / 1e3
        n = sum(e.count for e in ev)
        log(f"profile engine block, {kv or 'bf16'} pool, {ENGINE_ROWS} rows "
            f"x {ENGINE_BLOCK} steps: wall {wall:.1f} ms "
            f"({wall / ENGINE_BLOCK:.2f} a step), device {dev:.1f} ms "
            f"({dev / wall:.0%} busy), {n} kernels = "
            f"{n // ENGINE_BLOCK} a step")
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:9.2f} ms x{e.count:<6}"
                f" {e.key[:80]}")
        del eng
        torch.cuda.empty_cache()


def profile_host_reads(chat, cfg) -> None:
    """``--profile``, third part: what a read of the card per decode step
    costs. One row over a 2167-token prompt decodes 64 tokens through the
    engine (a block of 64 steps, state on the device, one read at the end)
    and through paged ``generate`` (``decode_from_logits`` reads
    ``all(done)`` back every step; the speculative loop does the same):
    ms a step of each."""
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    n, steps = PREFILL_ROWS, 64
    rng = np.random.default_rng(1)
    ids = rng.integers(10, cfg.llm.vocab_size - 2, n)
    pos = np.arange(n, dtype=np.float32)
    gc = GenerationConfig(max_new_tokens=steps + 1,
                          eos_token_ids=(cfg.llm.vocab_size - 1,))
    eng = InferenceEngine(chat, max_rows=1, max_len=4096, page_size=128,
                          chunk_size=512, decode_block=steps,
                          generation_config=gc, prefix_caching=False)
    times = []
    for _ in range(3):
        eng.decode_block = 1
        eng.submit(ids, pos, max_new_tokens=steps + 2)
        eng.step()                       # the admission and one step
        eng.decode_block = steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()                       # one block of 64 steps
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / steps * 1e3)
        eng.run_until_idle()
    args = (torch.as_tensor(ids[None]), torch.tensor([n]),
            torch.as_tensor(pos[None]), torch.zeros(1, 3, 448, 448),
            torch.zeros(1, dtype=torch.int32), chat.img_context_token_id)
    loop = []
    for _ in range(3):
        t = []
        for new in (1, steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(chat.model, cfg, dataclasses.replace(
                gc, max_new_tokens=new), *args, cache_mode="paged")
            torch.cuda.synchronize()
            t.append(time.perf_counter() - t0)
        loop.append((t[1] - t[0]) / steps * 1e3)
    log(f"profile host reads: one row over {n} tokens, {steps} decode "
        f"steps: engine block (no read inside) {sorted(times)[1]:.2f} ms a "
        f"step (3 runs: {', '.join(f'{x:.2f}' for x in times)}); "
        f"decode_from_logits (one read a step) {sorted(loop)[1]:.2f} ms a "
        f"step ({', '.join(f'{x:.2f}' for x in loop)})")


def probe_flash(device: str = "cuda") -> None:
    """``--probe``: a short first call for a changed flash tile. The
    compiler's registers and spills of the forward and backward sources;
    the two backward kernels against their twin at the sweep's random forms
    and at phase 2c's forms (on a synthetic packed row of PACKED_LEN tokens
    in three segments), each timed beside the library's backward; the flash
    forward against its twin at the sweep's random forms, the fused ring
    against its plain version at every head dim it takes, then both timed
    at their main forms beside scaled_dot_product_attention."""
    from v2pe_tpu_torch.ops import _build, flash_fwd
    from v2pe_tpu_torch.parallel import ring_fused

    for src in ("flash_bwd.cu", "flash_fwd.cu", "ring_fused_fwd.cu"):
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             "/dev/null", f"{_build.CSRC}/{src}"], capture_output=True,
            text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line or "wgmma" in line:
                log(f"probe {src}: {line.strip()}")
    phase_bwd_sweep(device)
    seg = torch.ones(1, PACKED_LEN, dtype=torch.int32)
    seg[:, PACKED_LEN // 3:], seg[:, 2 * PACKED_LEN // 3:] = 2, 3
    phase_bwd_kernels({"segment_ids": seg, "rope_pos_ids": torch.arange(
        PACKED_LEN, dtype=torch.float32)[None]}, device)
    phase_flash_sweep(device)
    g = torch.Generator(device="cpu").manual_seed(3)
    rn = lambda *shape: torch.randn(*shape, generator=g).to(
        device, torch.bfloat16)
    ids = lambda B, S: torch.arange(S, dtype=torch.int32,
                                    device=device).expand(B, S).contiguous()
    for D, B, S in ((16, 1, 512), (32, 1, 512), (64, 2, 1000),
                    (128, 2, 2000)):
        seg = torch.ones(B, S, dtype=torch.int32, device=device)
        seg[:, S // 3:], seg[:, S - 40:], seg[-1, :100] = 2, 0, 0
        zz = [_zigzag(a, RING_SHARDS) for a in (
            rn(B, S, 4, D), rn(B, S, 2, D), rn(B, S, 2, D), seg, seg,
            ids(B, S), ids(B, S))]
        kw = dict(causal=True, scale=D ** -0.5)
        text, ok, _ = check_ring(RING_SHARDS, zz, kw,
                                 *ring_fused.fused_ring_fwd(RING_SHARDS, *zz,
                                                            **kw))
        log(f"probe ring_fused_fwd D {D} B {B} S {S}: {text}")
        if not ok:
            raise AssertionError(f"fused ring disagrees at D {D}")
    Sq, Sk = 2167, 2199
    main = (rn(1, Sq, 16, 128), rn(1, Sk, 8, 128), rn(1, Sk, 8, 128),
            torch.ones(1, Sq, dtype=torch.int32, device=device),
            (ids(1, Sk) < Sq).int(), ids(1, Sq), ids(1, Sk))
    one = torch.ones(8, 1025, dtype=torch.int32, device=device)
    vit = (rn(8, 1025, 16, 64), rn(8, 1025, 16, 64), rn(8, 1025, 16, 64),
           one, one, ids(8, 1025), ids(8, 1025))
    for name, args, causal in (("dense_prefill_2167x2199", main, True),
                               ("vit_tiles_8x1025", vit, False)):
        kw = dict(causal=causal, scale=args[0].shape[3] ** -0.5)
        ms = time_ms(lambda: flash_fwd.flash_attention_fwd(*args, **kw), 20)
        lib = time_ms(lambda: sdpa(*args[:3], causal, kw["scale"]), 20)
        log(f"probe flash_fwd {name}: kernel {ms:.4f} ms, "
            f"scaled_dot_product_attention {lib:.4f} ms")
    S = RING_EVAL_TOKENS
    seg = torch.ones(1, S, dtype=torch.int32, device=device)
    seg[:, S // 3: 2 * S // 3], seg[:, 2 * S // 3:], seg[:, S - 200:] = 2, 3, 0
    zz = [_zigzag(a, RING_SHARDS) for a in (
        rn(1, S, 16, 128), rn(1, S, 8, 128), rn(1, S, 8, 128), seg, seg,
        ids(1, S), ids(1, S))]
    kw = dict(causal=True, scale=128 ** -0.5)
    ms = time_ms(lambda: ring_fused.fused_ring_fwd(RING_SHARDS, *zz, **kw), 3)
    log(f"probe ring_fused_fwd ring4_zigzag_{S}: kernel {ms:.3f} ms")


# ------------------------------------------------------------------- main


SPEC_CONTEXT = 32768  # prompt tokens of e2e_samples' speculative decode


def e2e_samples(chat, cfg) -> dict:
    """``--e2e``: a few samples each of the decode paths' end-to-end
    numbers, through whichever checkout's package is first on the path
    (``--root``), so that two checkouts compare in one call
    (``chip_ablate.py --family e2e``): the 34k session's decode rate (bf16
    pool, page 512; 3 samples), an engine decode step at 8 rows (the bench
    recipe's 8 x 8192 tokens; 2 blocks of 64 steps on the host clock) and
    the kernels a step of an 8-step block (torch.profiler's kernel events),
    and ``speculative_decode_from_logits`` after a 32,768-token prompt that
    repeats a 64-token pattern (K = 4, 64 new tokens; a warm run, then 2
    samples): its rate, verify forwards and reads of the card
    (``count_syncs``). Uses only entry points that checkouts from before
    the store rode in the decode launch have too."""
    from torch.profiler import ProfilerActivity, profile

    from v2pe_tpu_torch.infer import speculative
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.infer.session import ChatSession

    res = {}
    rng = np.random.default_rng(12)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    sess = ChatSession(chat, max_len=LONG_HISTORY + 2 * LONG_TURN,
                       page_size=512)
    sess.send(None, "".join(rng.choice(letters, LONG_HISTORY)),
              GenerationConfig(max_new_tokens=1))
    res["session_34k_decode_tok_s"] = []
    for _ in range(3):
        steps, t_many, t_one, _ = session_decode(sess, cfg)
        res["session_34k_decode_tok_s"].append(steps / (t_many - t_one))
    del sess
    torch.cuda.empty_cache()

    eng = engine_recipe(chat, cfg)
    _engine_submit(eng, cfg, np.random.default_rng(0), ENGINE_ROWS,
                   ENGINE_NEW)
    eng.step()  # the admissions and a first block
    res["engine_step_ms_8rows"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        res["engine_step_ms_8rows"].append(
            (time.perf_counter() - t0) * 1e3 / ENGINE_BLOCK)
    eng.decode_block = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    res["engine_kernels_a_step"] = sum(
        e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 8
    del eng, prof
    torch.cuda.empty_cache()

    V = cfg.llm.vocab_size
    prompt = np.tile(np.random.default_rng(31).integers(10, 90000, 64),
                     SPEC_CONTEXT // 64)
    gc = GenerationConfig(max_new_tokens=64, speculative_k=4,
                          speculative_ngram=3, eos_token_ids=(V - 1,))
    own, seen = speculative.speculative_decode_from_logits, {}

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, seen["reads"] = count_syncs(lambda: own(*a, **kw))
        torch.cuda.synchronize()
        seen["seconds"] = time.perf_counter() - t0
        return out

    w = next(chat.model.parameters())
    dev = w.device
    speculative.speculative_decode_from_logits = timed
    rates = []
    try:
        for _ in range(3):  # a warm run, then the samples
            _, steps, lens = generate(
                chat.model, cfg, gc,
                torch.as_tensor(prompt[None], device=dev),
                torch.tensor([len(prompt)], device=dev),
                torch.arange(len(prompt), dtype=torch.float32,
                             device=dev)[None],
                torch.zeros((1, 3, cfg.vision.image_size,
                             cfg.vision.image_size), dtype=w.dtype,
                            device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev),
                chat.img_context_token_id, cache_mode="paged",
                page_size=128)
            rates.append(int(lens[0]) / seen["seconds"])
    finally:
        speculative.speculative_decode_from_logits = own
    res.update(spec_decode_32k_tok_s=rates[1:],
               spec_tokens=int(lens[0]), spec_verify_forwards=int(steps),
               spec_reads=seen["reads"])
    return res


def kernel_record(name: str, recs: list, launches: int) -> dict:
    """One kernel's entry of the JSON line: the launches of the driven
    paths; the largest error over all forms; time, plain time, bound and
    library time at its main form (named under "form"). Every other form
    has its own ``kernel ...`` line above."""
    main = [f for f in recs if f["main"]]
    if len(main) != 1:
        raise AssertionError(f"{name}: {len(main)} main forms")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rec = dict(name=name, route="cuda", source=KERNEL_SOURCES[name],
               replaces=KERNEL_REPLACES[name], launches=launches,
               max_abs_err=max(f["max_abs_err"] for f in recs),
               form=main[0]["form"], **{k: main[0][k] for k in keys})
    # the paged kernels: the main form again over an int8 and an int4 pool
    pools = {f["pool"]: {"form": f["form"], "max_abs_err": f["max_abs_err"],
                         **{k: f[k] for k in keys}}
             for f in recs if f.get("pool")}
    if pools:
        rec["pools"] = pools
    return rec



def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="only profile the 8-tile request's generate (dense, "
                    "paged, int8 pool) with torch.profiler; no result line")
    ap.add_argument("--profile-train", action="store_true",
                    help="only profile one full-width train step with "
                    "torch.profiler; no result line")
    ap.add_argument("--e2e", action="store_true",
                    help="only one sample each of the decode paths' end-to-"
                    "end numbers (e2e_samples), as a JSON line; no result "
                    "line")
    ap.add_argument("--root", default=None,
                    help="with --e2e: the checkout whose v2pe_tpu_torch is "
                    "driven (default: this one)")
    ap.add_argument("--probe", action="store_true",
                    help="only check and time the flash tiles (the "
                    "backward #2-#3, the forward #1, #11) at a few forms; "
                    "no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.root:  # before anything of the package is imported
        sys.path.insert(0, os.path.abspath(args.root))
    seconds, mark = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        """Seconds since the last lap, kept under ``name``."""
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    if args.probe:
        probe_flash()
        log(card_line())
        return 0

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
    if args.e2e:
        log(json.dumps({"e2e": e2e_samples(chat, cfg)}))
        log(card_line())
        return 0
    if args.profile or args.profile_train:
        if args.profile:
            profile_generate(chat, cfg)
            profile_engine_block(chat, cfg)
            profile_host_reads(chat, cfg)
        else:
            profile_train(model, cfg)
        log(card_line())
        return 0
    lap("build and model")
    batch = packed_batch(chat, PACKED_LEN, "cuda")
    prompt_lens = prompt_lengths(chat)
    forms = {"flash_fwd": phase_kernels(prompt_lens, batch)
             + phase_flash_sweep(), **phase_bwd_kernels(batch)}
    # the backward's random forms, the paged and quantized kernels, the
    # ring: the fused forward's forms, and the flash kernels' forms at the
    # rectangles the ring cuts
    for recs in (phase_bwd_sweep(), phase_paged_kernels(prompt_lens),
                 phase_quant_kernels(cfg), phase_quant_sweep(),
                 phase_ring_kernel(),
                 phase_ring_bwd(), phase_rank_forms(batch)):
        for name, more in recs.items():
            forms.setdefault(name, []).extend(more)
    lap("kernels")
    for name, more in phase_paged_sweep().items():
        forms[name].extend(more)
    lap("paged sweep")
    phase_small_reference()
    phase_small_train_reference()
    phase_small_ring_reference()
    phase_small_quant_reference()
    phase_small_engine_reference()
    phase_small_slice_reference()
    phase_small_shard_reference()
    lap("references")
    served = phase_serve(chat, cfg)
    phase_stream(chat, cfg, served)
    phase_packed(chat, cfg, batch)
    # the paged paths, each driven with the launch counts zeroed before it
    paths = [served["counts"], phase_paged_serve(model, cfg, tok, served),
             phase_session(model, cfg, tok), phase_worker(model, cfg, tok)]
    quant_paths, quantized = phase_quant_serve(model, cfg, tok, served)
    paths += quant_paths
    paths.append(phase_w4kv4(quantized["int4"], cfg, tok))
    del quantized
    torch.cuda.empty_cache()
    lap("serve")
    # the continuous-batching engine
    paths.append(phase_engine(chat, cfg))
    paths += phase_engine_chat(model, cfg, tok, served)
    paths.append(phase_spec_reads(chat, cfg))
    phase_beam(chat, cfg)
    del chat
    lap("engine")
    # the serving paths over a pool split into sequence shards on this card
    paths += phase_seq_shards(model, cfg, tok, served)
    lap("seq shards")
    # the checkpoint written and read back, then the eval CLI's routes
    paths += phase_checkpoint_eval(model, cfg, tok)
    lap("checkpoint and eval")
    # sequence parallelism: the long teacher-forced eval over the ring
    paths.append(phase_ring_eval(model, cfg))
    lap("ring eval")
    # LoRA: the adapters train over the frozen weights, which stay as they
    # are, then serve and export merged
    counts, merged, lora, before = phase_lora_train(model, cfg)
    paths.append(counts)
    phase_lora_utils(model, cfg, lora)
    paths += phase_lora_serve(model, cfg, tok, served, merged, lora, before)
    del merged, lora, before
    torch.cuda.empty_cache()
    lap("lora")
    # last: the training paths update the weights
    paths.append(phase_train(model, cfg))
    lap("train")
    # the mesh's training path as a world of 1, on a copy of the weights the
    # bench recipe then starts from
    dist_counts, dist_steps, serve_counts, dist_moments, lora_counts, \
        compress_counts = phase_dist_train(model, cfg)
    paths += [dist_counts, serve_counts, lora_counts, compress_counts,
              phase_bench_recipe(model, cfg, dist_steps, dist_moments),
              phase_ring_train(model, cfg)]
    del dist_moments
    phase_two_ranks()
    lap("dist train, bench recipe, ring train")
    paths += phase_compress_train(model, cfg)
    paths.append(phase_compress_fuse_only(model, cfg))
    paths.append(phase_seq_cls(model, cfg))
    launches = {k: sum(c[k] for c in paths) for k in forms}
    lap("compress and seq-cls")
    log(f"seconds: {json.dumps(seconds)}, {sum(seconds.values()):.1f} in "
        f"all")
    records = [kernel_record(name, recs, launches[name])
               for name, recs in forms.items()]
    for rec in records:
        if rec["name"] == "paged_store":
            # on the main path the store runs inside paged_decode's
            # launches (paged_decode_store); its own launches stay apart
            riding = sum(c["paged_decode_store"] for c in paths)
            rec.update(launches=rec["launches"] + riding,
                       standalone_launches=rec["launches"],
                       riding_launches=riding, rides_in="paged_decode")
    log(json.dumps({"kernels": records}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
