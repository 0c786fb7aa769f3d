"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):
  1. device: the card's name and power limit, torch/CUDA versions, and the
     build of the CUDA kernels from this checkout's sources;
  2. kernels: the flash-attention kernel against its plain PyTorch twin at
     every form the serving path gives it, with errors and times;
  3. serve: InternVL2-2B at full width (bf16, random weights from a seed)
     answers three chat requests through ChatModel.batch_chat, and the
     kernel's launch count shows the path went through it;
  4. stream: stream_generate's tokens equal generate's greedy tokens;
  5. packed: one packed 8192-token forward with 8 image tiles.
A small fp32 forward on the card against the same forward on the CPU (the
kernel against its twin, inside the whole model) runs after phase 2.
The kernel table prints as one JSON line, then the card line, then the last
line {"ok": true, "device": {...}}.

Imports neither jax nor the JAX package, nor PIL/transformers/tokenizers:
the pixels come from numpy and the text from a code-point tokenizer.
"""

from __future__ import annotations

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
KERNEL_SOURCE = "v2pe_tpu_torch/csrc/flash_fwd.cu"
MAX_NEW = 32
PACKED_LEN = 8192
REQUESTS = [  # (image tiles, question) of the served requests
    (8, "<image>\nDescribe the image in detail."),
    (1, "<image>\nWhat is shown here?"),
    (0, "请用一句话介绍你自己。"),
]
KERNEL_REPLACES = "v2pe_tpu/ops/flash_pallas.py:68"


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


def phase_serve(chat, cfg) -> dict:
    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.ops import flash_fwd

    gc = GenerationConfig(max_new_tokens=MAX_NEW)
    pixels = _request_pixels()
    n_layers = cfg.vision.num_hidden_layers + cfg.llm.num_hidden_layers
    flash_fwd.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = chat.batch_chat(pixels, [q for _, q in REQUESTS], gc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_fwd.LAUNCHES
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
    args = (torch.as_tensor(ids[None]), torch.tensor([len(ids)]),
            torch.as_tensor(pos[None]), torch.as_tensor(pixels[0]),
            torch.ones(tiles, dtype=torch.int32), chat.img_context_token_id)
    stop = tuple(chat.conv_template.stop_token_ids)
    first = GenerationConfig(max_new_tokens=1, eos_token_ids=stop)
    full = GenerationConfig(max_new_tokens=MAX_NEW, eos_token_ids=stop)
    generate(chat.model, cfg, first, *args)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(chat.model, cfg, first, *args)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens, _, lens = generate(chat.model, cfg, full, *args)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    n = int(lens[0])
    rate = (n - 1) / (total - ttft) if n > 1 else float("nan")
    log(f"serve: prompt {len(ids)} tokens ({tiles} tiles): TTFT "
        f"{ttft * 1e3:.1f} ms, {n} tokens in {total * 1e3:.1f} ms, decode "
        f"{rate:.1f} tok/s")
    return dict(launches=launches, ids=ids, pos=pos, pixels=pixels[0],
                gc=full, tokens=tokens[0, :n].cpu().numpy())


# ---------------------------------------------------------------- phase 4


def phase_stream(chat, cfg, served: dict) -> None:
    from v2pe_tpu_torch.infer.streaming import stream_generate

    stop = set(served["gc"].eos_token_ids)
    chunks = list(stream_generate(
        chat.model, cfg, served["gc"], served["ids"][None],
        served["pos"][None], served["pixels"],
        np.ones(len(served["pixels"]), np.int32),
        chat.img_context_token_id, chunk=8))
    streamed = [int(t) for c in chunks for t in c]
    generated = [int(t) for t in served["tokens"]]
    while generated and generated[-1] in stop:
        generated.pop()
    while streamed and streamed[-1] in stop:
        streamed.pop()
    log(f"stream: {len(chunks)} chunks, {len(streamed)} tokens, equal to "
        f"generate: {streamed == generated}")
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


def phase_small_reference() -> None:
    """The whole packed forward at a small width in fp32: on the card
    (through the kernel) against the CPU (through the twin)."""
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


# ------------------------------------------------------------------- main


def main() -> int:
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
    chat = ChatModel(model, cfg, CodePointTokenizer())
    batch = packed_batch(chat, PACKED_LEN, "cuda")
    forms = phase_kernels(prompt_lengths(chat), batch)
    phase_small_reference()
    served = phase_serve(chat, cfg)
    phase_stream(chat, cfg, served)
    phase_packed(chat, cfg, batch)

    kernels = [dict(
        name="flash_fwd", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=served["launches"],
        max_abs_err=max(f["max_abs_err"] for f in forms),
        ms=sum(f["ms"] for f in forms),
        plain_ms=sum(f["plain_ms"] for f in forms), forms=forms)]
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
