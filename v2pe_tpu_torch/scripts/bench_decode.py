"""TTFT and decode rate of one request at a chosen context (counterpart
of ``scripts/bench_decode.py``): random bf16 weights of a preset from a
seed, a synthetic packed prompt of ``--seq-len`` tokens with ``--tiles``
image tiles (``train/synth.py``), then

* TTFT: the prefill (ViT, the LLM over the prompt into the cache, the last
  position's logits and the first token), the median of ``--repeats``
  calls after a warm one;
* decode: ``--decode-tokens`` greedy steps over that cache, tokens a
  second, the median likewise.

Host clock around each call after ``torch.cuda.synchronize`` (each is
many kernels long). One JSON line a metric, each naming the card and its
power limit. Runs on the card unless ``--platform cpu``:

    python -m v2pe_tpu_torch.scripts.bench_decode [--seq-len 8192] \
        [--tiles 8] [--decode-tokens 64] [--cache-mode dense|paged] \
        [--weights-dtype int8|int4] [--model-preset internvl2_2b]

``chip_smoke.py`` times the same split for its 8-tile request
(``phase_serve``, ``time_request``); this script picks the context.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seq-len", type=int, default=8192)
    p.add_argument("--tiles", type=int, default=8)
    p.add_argument("--decode-tokens", type=int, default=64)
    p.add_argument("--cache-mode", choices=["dense", "paged"],
                   default="dense")
    p.add_argument("--weights-dtype", choices=["int8", "int4"],
                   default=None)
    p.add_argument("--model-preset", default="internvl2_2b")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="the card (default) or, only when asked, the CPU")
    return p


def main(argv=None, model=None) -> list:
    """Print and return the metric lines. ``model``: a model of the preset
    already on the device, in place of drawing one."""
    args = build_argparser().parse_args(argv)
    import torch

    from v2pe_tpu_torch.core import config as cfg_lib
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.infer.streaming import _decode_chunk, _prefill
    from v2pe_tpu_torch.models.internvl_chat import with_llm
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.scripts._card import card
    from v2pe_tpu_torch.train.synth import (IMG_CONTEXT_ID,
                                            make_synthetic_batch)

    if args.platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available; "
                           "pass --platform cpu to run on the CPU")
    device = torch.device(args.platform)
    cfg = getattr(cfg_lib, args.model_preset)()
    if model is None:
        model = init_vlm_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device, dtype=torch.bfloat16)
    if args.weights_dtype:
        from v2pe_tpu_torch.ops.quantized_matmul import quantize_llm_params

        model = with_llm(model, quantize_llm_params(
            model.llm, 8 if args.weights_dtype == "int8" else 4))
    b = make_synthetic_batch(cfg, 1, args.seq_len, tiles_per_row=args.tiles,
                             stride=cfg.rope_pos_id_stride or 64,
                             seed=args.seed)
    ids = torch.from_numpy(b["input_ids"]).to(device)
    pos = torch.from_numpy(b["rope_pos_ids"]).to(device)
    pixels = torch.from_numpy(b["pixel_values"]).to(device, torch.bfloat16)
    flags = torch.from_numpy(b["image_flags"]).to(device)
    gc = GenerationConfig(max_new_tokens=args.decode_tokens)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    total = args.seq_len + args.decode_tokens

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    def prefill():
        return _prefill(model, cfg, gc, ids, pos, pixels, flags,
                        IMG_CONTEXT_ID, total, gen,
                        cache_mode=args.cache_mode)

    def decode(tok, cache):
        done = torch.zeros((1,), dtype=torch.bool, device=device)
        return _decode_chunk(model, cfg, gc, cache, tok, pos[:, -1] + 1.0,
                             done, gen, chunk=args.decode_tokens)

    ttfts, rates = [], []
    with torch.inference_mode():
        for i in range(args.repeats + 1):  # the first call warms up
            dt, (tok, cache) = timed(prefill)
            dd, _ = timed(lambda: decode(tok, cache))
            if i:
                ttfts.append(dt)
                rates.append(args.decode_tokens / dd)
    where = card(device)
    k = args.seq_len // 1024
    tag = f"{args.cache_mode}" + (f"_{args.weights_dtype}"
                                  if args.weights_dtype else "")
    lines = [
        {"metric": f"ttft_{k}k_{args.tiles}tiles_{tag}_ms",
         "value": statistics.median(ttfts) * 1e3, "unit": "ms",
         "samples": [t * 1e3 for t in ttfts], "card": where},
        {"metric": f"decode_tok_s_{k}k_{tag}",
         "value": statistics.median(rates), "unit": "tok/s",
         "samples": rates, "card": where}]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
