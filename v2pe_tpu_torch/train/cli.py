"""Training CLI (port of ``v2pe_tpu/train/cli.py``): the same flags,
training on one device.

Flags that need a module the port does not have yet raise
``NotImplementedError``: a mesh axis above 1, LoRA, ``--compress_seq``,
``--model_name_or_path`` (the safetensors converter), a decoder family
other than internlm2, ``--ring_mode fused``, ``--offload_optimizer`` and a
multi-host launcher.

Example (a toy dataset and tokenizer, see the README):
  python -m v2pe_tpu_torch.train.cli --model_preset debug_tiny \
      --tokenizer tok/ --meta_path ds/meta.json --output_dir out \
      --max_steps 4 --save_steps 2 --max_packed_tokens 1024 --max_tiles 8
"""

from __future__ import annotations

import argparse
import logging


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # model
    p.add_argument("--model_name_or_path", default=None,
                   help="HF checkpoint dir (safetensors) to convert; "
                        "random init if omitted")
    p.add_argument("--model_preset", default="internvl2_2b",
                   choices=["internvl2_2b", "internvl2_5_8b", "debug_tiny"])
    p.add_argument("--llm_arch", default=None,
                   choices=["internlm2", "qwen2", "llama", "phi3"],
                   help="override the preset's decoder family (the "
                        "composite-LLM dispatch of "
                        "modeling_internvl_chat.py:108-117; qwen2 enables "
                        "qkv bias and the repacked-wqkv converter)")
    p.add_argument("--tokenizer", required=True,
                   help="HF tokenizer name or path")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    # data
    p.add_argument("--meta_path", required=True)
    p.add_argument("--conv_style", "--template", dest="conv_style",
                   default="internlm2-chat",
                   choices=["internlm2-chat", "internvl2_5", "Hermes-2",
                            "phi3-chat", "vicuna_v1.1"],
                   help="chat template; picks the label-masking routine "
                        "(internvl_chat_finetune.py:520-527)")
    p.add_argument("--force_image_size", type=int, default=448)
    p.add_argument("--max_dynamic_patch", type=int, default=12)
    p.add_argument("--min_dynamic_patch", type=int, default=1)
    p.add_argument("--use_thumbnail", action="store_true", default=True)
    p.add_argument("--pad2square", action="store_true", default=False)
    p.add_argument("--max_packed_tokens", type=int, default=32768)
    p.add_argument("--max_tiles", type=int, default=64)
    p.add_argument("--rows_per_batch", type=int, default=1)
    p.add_argument("--loss_reduction", default="token",
                   choices=["token", "sample", "square"])
    # V2PE
    p.add_argument("--rope_pos_id_version", default="v2pe_fix",
                   choices=["default", "v2pe_fix", "v2pe_rnd"])
    p.add_argument("--rope_pos_id_stride", type=int, default=64)
    # parallelism (replaces --attn_type ring --chunk_num N + DeepSpeed cfg)
    p.add_argument("--platform", default=None,
                   choices=["cpu", "cuda", "gpu"],
                   help="the device to train on (default: the CUDA card "
                        "when there is one, else the CPU)")
    p.add_argument("--launcher", default="auto",
                   choices=["auto", "env", "slurm", "mpi", "tpu", "none"],
                   help="multi-host bootstrap detection "
                        "(dist_utils.py:32-104 analogue); 'auto' inspects "
                        "env vars, 'none' forces single-process")
    p.add_argument("--coordinator_port", type=int, default=8476)
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_seq", type=int, default=1,
                   help="ring-attention shards (reference chunk_num)")
    p.add_argument("--mesh_tensor", type=int, default=1)
    p.add_argument("--mesh_pipe", type=int, default=1,
                   help="pipeline-parallel stages over decoder layers "
                        "(GPipe over DCN; parallel/pipeline.py)")
    p.add_argument("--pipe_microbatches", type=int, default=0,
                   help="GPipe microbatches (0 = auto; must divide the "
                        "global row count)")
    p.add_argument("--ring_mode", choices=["scan", "fused"], default="scan",
                   help="ring-attention transport: 'scan' = ppermute ring "
                        "(memory-lean), 'fused' = in-kernel RDMA streaming "
                        "(parallel/ring_fused.py; holds gathered KV). "
                        "Off-TPU, 'fused' runs via the Pallas interpreter "
                        "and requires --no_remat (its DMA-simulator IO "
                        "effects cannot live under jax.checkpoint)")
    p.add_argument("--sync_save", action="store_true",
                   help="write checkpoints synchronously (default: async — "
                        "the step loop resumes once arrays are snapshotted "
                        "to host; disk writes overlap training)")
    p.add_argument("--no_remat", action="store_true",
                   help="disable per-layer rematerialization (gradient "
                        "checkpointing); faster but peak-memory-heavy — "
                        "only for small models/contexts")
    p.add_argument("--remat_policy", default="full",
                   choices=["full", "block2", "block4", "attn_saved"],
                   help="decoder remat granularity (docs/perf_analysis.md "
                        "training section): 'full' per-layer (default); "
                        "'block2'/'block4' checkpoint 2/4-layer blocks — "
                        "half/quarter the residual memory, same recompute "
                        "(fits the 32k recipe on one 16 GB chip); "
                        "'attn_saved' keeps attention residuals and remats "
                        "only the MLP — fastest when memory allows")
    p.add_argument("--offload_optimizer", action="store_true",
                   help="keep optimizer state in pinned HOST memory and "
                        "stage it through HBM only for the update "
                        "(ZeRO-Offload equivalent) — separates the "
                        "backward's and the update's memory peaks; the "
                        "knob that fits the 32k-recipe step on one 16 GB "
                        "chip (docs/perf_analysis.md training section)")
    # training-recipe knobs (internvl_chat_finetune.py:110-150)
    p.add_argument("--drop_path_rate", type=float, default=0.0,
                   help="ViT stochastic depth; published V2PE recipes "
                        "use 0.1")
    p.add_argument("--use_backbone_lora", type=int, default=0,
                   help="LoRA rank for the ViT tower (0 = full finetune; "
                        "wrap_backbone_lora parity, "
                        "modeling_internvl_chat.py:142-152)")
    p.add_argument("--use_llm_lora", type=int, default=0,
                   help="LoRA rank for the LLM (0 = full finetune; "
                        "wrap_llm_lora parity, "
                        "modeling_internvl_chat.py:153-163). Checkpoints "
                        "then store the adapter tree only; export merged "
                        "weights with tools/export_hf.py --lora-base")
    p.add_argument("--freeze_llm", action="store_true")
    p.add_argument("--freeze_backbone", action="store_true")
    p.add_argument("--freeze_mlp", action="store_true")
    p.add_argument("--unfreeze_lm_head", action="store_true")
    p.add_argument("--unfreeze_vit_layers", type=int, default=0)
    # compress-seq experimental trainer (finetune.py:159-176)
    p.add_argument("--compress_seq", action="store_true")
    p.add_argument("--fuse_method", choices=["add", "cross-attn"],
                   default="add")
    p.add_argument("--compress_method", choices=["avg"], default="avg")
    p.add_argument("--chunk_num", type=int, default=4,
                   help="compress-seq chunks per sequence")
    p.add_argument("--report_to", nargs="*", default=["jsonl"],
                   choices=["jsonl", "tensorboard", "none"],
                   help="metrics sinks (HF report_to analogue)")
    # optimizer
    p.add_argument("--use_8bit_optimizer", action="store_true",
                   help="block-wise int8 Adam moments (bnb Adam8bit "
                        "analogue, trainer_monkey_patch.py:147-159)")
    p.add_argument("--learning_rate", type=float, default=4e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--vit_lr_scale", type=float, default=1.0)
    p.add_argument("--vit_layer_decay_rate", type=float, default=1.0)
    p.add_argument("--grad_accum_steps", type=int, default=1)
    # run
    p.add_argument("--output_dir", default="out")
    p.add_argument("--save_steps", type=int, default=2500)
    p.add_argument("--save_total_limit", type=int, default=5)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_resume", action="store_true")
    return p


def _unported(args) -> list:
    """The flags given that need a module the port lacks."""
    mesh = {a: getattr(args, f"mesh_{a}") for a in
            ("data", "fsdp", "seq", "tensor", "pipe")}
    checks = [
        (any(v > 1 for v in mesh.values()), f"mesh axes {mesh}"),
        (args.pipe_microbatches, "--pipe_microbatches"),
        (args.ring_mode != "scan", "--ring_mode fused"),
        (args.use_backbone_lora or args.use_llm_lora, "LoRA"),
        (args.compress_seq, "--compress_seq"),
        (args.model_name_or_path, "--model_name_or_path"),
        (args.llm_arch not in (None, "internlm2"), f"--llm_arch "
                                                   f"{args.llm_arch}"),
        (args.offload_optimizer, "--offload_optimizer"),
        (args.launcher not in ("auto", "none"), f"--launcher "
                                                f"{args.launcher}"),
    ]
    return [what for flag, what in checks if flag]


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = build_argparser().parse_args(argv)
    missing = _unported(args)
    if missing:
        raise NotImplementedError(f"not ported: {', '.join(missing)}")

    import dataclasses

    import numpy as np
    import torch
    from transformers import AutoTokenizer

    from v2pe_tpu.core import config as cfg_lib
    from v2pe_tpu.data.constants import IMG_CONTEXT_TOKEN, SPECIAL_TOKENS
    from v2pe_tpu.data.datasets import build_datasets
    from v2pe_tpu.data.packing import PackedSampleIterator
    from v2pe_tpu_torch.models.params import init_vlm_params
    from v2pe_tpu_torch.train.metrics import build_metrics_hook
    from v2pe_tpu_torch.train.optimizer import TrainConfig
    from v2pe_tpu_torch.train.trainer import RunConfig, train

    device = {"gpu": "cuda"}.get(args.platform, args.platform) or (
        "cuda" if torch.cuda.is_available() else "cpu")
    cfg = getattr(cfg_lib, args.model_preset)()
    cfg = dataclasses.replace(
        cfg, rope_pos_id_version=args.rope_pos_id_version,
        rope_pos_id_stride=args.rope_pos_id_stride,
        max_dynamic_patch=args.max_dynamic_patch,
        min_dynamic_patch=args.min_dynamic_patch,
        force_image_size=args.force_image_size,
        vision=dataclasses.replace(cfg.vision,
                                   drop_path_rate=args.drop_path_rate))
    if cfg.llm.arch != "internlm2":
        raise NotImplementedError(f"not ported: the {cfg.llm.arch} decoder "
                                  f"of --model_preset {args.model_preset}")

    tokenizer = AutoTokenizer.from_pretrained(args.tokenizer,
                                              trust_remote_code=True)
    tokenizer.add_tokens(list(SPECIAL_TOKENS), special_tokens=True)
    ctx_id = tokenizer.convert_tokens_to_ids(IMG_CONTEXT_TOKEN)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = init_vlm_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device, dtype=dtype)

    dsets = build_datasets(
        args.meta_path, tokenizer, template_name=args.conv_style,
        num_image_token=cfg.num_image_token,
        image_size=args.force_image_size,
        max_dynamic_patch=args.max_dynamic_patch,
        min_dynamic_patch=args.min_dynamic_patch,
        rope_pos_id_version=args.rope_pos_id_version,
        rope_pos_id_stride=args.rope_pos_id_stride, seed=args.seed)
    packer = PackedSampleIterator(
        dsets, max_tokens=args.max_packed_tokens,
        max_tiles_per_row=args.max_tiles, seed=args.seed,
        loss_reduction=args.loss_reduction, img_context_token_id=ctx_id)
    run = RunConfig(
        output_dir=args.output_dir, max_steps=args.max_steps,
        save_steps=args.save_steps, save_total_limit=args.save_total_limit,
        log_steps=args.log_steps, max_packed_tokens=args.max_packed_tokens,
        rows_per_batch=args.rows_per_batch, max_tiles=args.max_tiles,
        loss_reduction=args.loss_reduction, seed=args.seed)
    tc = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        max_grad_norm=args.max_grad_norm, vit_lr_scale=args.vit_lr_scale,
        vit_layer_decay_rate=args.vit_layer_decay_rate,
        grad_accum_steps=args.grad_accum_steps,
        use_8bit_optimizer=args.use_8bit_optimizer,
        freeze_llm=args.freeze_llm, freeze_backbone=args.freeze_backbone,
        freeze_mlp=args.freeze_mlp, unfreeze_lm_head=args.unfreeze_lm_head,
        unfreeze_vit_layers=args.unfreeze_vit_layers)
    hook = build_metrics_hook(args.output_dir, args.report_to)
    return train(cfg, model, packer, run, tc, img_context_token_id=ctx_id,
                 resume=not args.no_resume, pixel_dtype=np.float32,
                 metrics_hook=hook,
                 remat=False if args.no_remat else args.remat_policy,
                 async_save=not args.sync_save)


if __name__ == "__main__":
    main()
