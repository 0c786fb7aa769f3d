"""Train step throughput under each remat policy, and the step at the
32k recipe's shape (counterpart of ``scripts/verify_train_remat.py``).

The bench recipe's step (``make_train_step``, int8 Adam, lr 1e-5, warmup
1) on ``make_synthetic_batch``'s one row of ``--tokens`` tokens with
``--tiles`` tiles at V2PE stride 64, random bf16 weights of a preset from
a seed: ``--steps`` steps after a warm one under each of ``--policies``
(median ms, tokens a second, peak GiB allocated); then, unless
``--long-tokens 0``, the same step at ``--long-tokens`` tokens and
``--long-tiles`` tiles (the 32k recipe's unit of work, remat 'full'),
which the JAX package could only time without its optimizer on a 16 GB
chip. Host clock to the read of the loss. One JSON line a measurement,
each naming the card and its power limit. Runs on the card unless
``--platform cpu``:

    python -m v2pe_tpu_torch.scripts.bench_train_remat \
        [--policies full block2 attn_saved] [--long-tokens 32768]

``chip_smoke.py`` times the 'full' step alone (``phase_train``,
``phase_bench_recipe``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--policies", nargs="+",
                   default=["full", "block2", "attn_saved"])
    p.add_argument("--tokens", type=int, default=8192)
    p.add_argument("--tiles", type=int, default=8)
    p.add_argument("--long-tokens", type=int, default=32768)
    p.add_argument("--long-tiles", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--model-preset", default="internvl2_2b")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                   help="the card (default) or, only when asked, the CPU")
    return p


def main(argv=None, model=None) -> list:
    """Print and return the measurement lines. ``model``: a bf16 model of
    the preset already on the device, in place of drawing one (its
    weights are trained in place)."""
    args = build_argparser().parse_args(argv)
    import torch

    from v2pe_tpu_torch.core import config as cfg_lib
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.scripts._card import card
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer
    from v2pe_tpu_torch.train.synth import (IMG_CONTEXT_ID,
                                            make_synthetic_batch)
    from v2pe_tpu_torch.train.train_step import make_train_step

    if args.platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available; "
                           "pass --platform cpu to run on the CPU")
    device = torch.device(args.platform)
    cuda = device.type == "cuda"
    cfg = getattr(cfg_lib, args.model_preset)()
    if model is None:
        model = init_vlm_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device=device, dtype=torch.bfloat16)
    opt = build_optimizer(TrainConfig(learning_rate=1e-5, warmup_steps=1,
                                      total_steps=1000,
                                      use_8bit_optimizer=True), model, cfg)
    state = opt.init()
    where, lines = card(device), []

    def run(remat, tokens, tiles, key):
        step = make_train_step(cfg, opt, img_context_token_id=IMG_CONTEXT_ID,
                               remat=remat)
        b = make_synthetic_batch(cfg, 1, tokens, tiles_per_row=tiles,
                                 stride=64, seed=args.seed)
        batch = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        batch["pixel_values"] = batch["pixel_values"].to(torch.bfloat16)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        model.train()
        ms = []
        for i in range(args.steps + 1):  # the first step warms up
            t0 = time.perf_counter()
            loss, _ = step(model, state, batch)
            loss = loss.item()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        model.eval()
        med = statistics.median(ms)
        line = {"metric": key, "value": tokens / med * 1e3,
                "unit": "tok/s", "step_ms": med, "samples_ms": ms,
                "loss": loss, "remat": remat, "card": where}
        if cuda:
            line["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(json.dumps(line), flush=True)
        lines.append(line)

    k = args.tokens // 1024
    for remat in args.policies:
        run(remat, args.tokens, args.tiles,
            f"train_tok_s_{k}k_{args.tiles}tiles_{remat}")
    if args.long_tokens:
        run("full", args.long_tokens, args.long_tiles,
            f"train_tok_s_{args.long_tokens // 1024}k_{args.long_tiles}tiles"
            f"_full")
    return lines


if __name__ == "__main__":
    main()
