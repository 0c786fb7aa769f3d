"""Export a checkpoint of the port back to HF safetensors (counterpart of
``tools/export_hf.py``).

Reads a step directory that ``core/checkpoint.py`` wrote (``params.pt``,
``config.json``; given the run's output directory, its latest committed
step), converts the model to the InternVLChatModel key layout
(``models/export.py``) and writes ``model.safetensors``. ``--hf-template``
(the original HF checkpoint directory) copies its config, tokenizer and
remote-code files next to the weights. With ``--lora-base``, the checkpoint
is an adapter checkpoint of a LoRA run (``train/cli.py --use_llm_lora`` /
``--use_backbone_lora``): the adapters are merged into the base weights it
names (a port step directory with ``params.pt``, or an HF safetensors
directory) before the export.

    python -m v2pe_tpu_torch.tools.export_hf --checkpoint out/step_00020000 \
        --config-preset internvl2_2b --out export_dir \
        [--hf-template pretrained/InternVL2-2B] [--dtype bfloat16] \
        [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="step dir (contains params.pt) or its parent")
    p.add_argument("--config-preset", default="internvl2_2b")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--hf-template", default=None,
                   help="original HF checkpoint dir; its non-weight files "
                        "are copied into --out")
    p.add_argument("--lora-base", default=None,
                   help="when --checkpoint is a LoRA ADAPTER checkpoint, "
                        "the base weights to merge into: a step dir "
                        "(params.pt) or an HF safetensors dir")
    p.add_argument("--platform", default="cuda",
                   choices=["cpu", "cuda", "gpu"],
                   help="the device the checkpoint is loaded onto: the CUDA "
                        "card (default; raises when there is none) or, "
                        "only when asked for, the CPU")
    return p


def main(argv=None) -> str:
    args = build_argparser().parse_args(argv)

    import torch

    from v2pe_tpu_torch.core import config as cfg_lib
    from v2pe_tpu_torch.core.checkpoint import latest_checkpoint
    from v2pe_tpu_torch.models.export import (export_torch_state_dict,
                                              save_safetensors)
    from v2pe_tpu_torch.models.lora import lora_from_state_dict
    from v2pe_tpu_torch.models.params import (load_safetensors_checkpoint,
                                              model_from_state_dict)

    device = {"gpu": "cuda"}.get(args.platform, args.platform)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available; "
                           "pass --platform cpu to export on the CPU")
    ckpt = args.checkpoint
    if not os.path.isfile(os.path.join(ckpt, "params.pt")):
        latest = latest_checkpoint(ckpt)
        if latest is None:
            raise SystemExit(f"no params.pt under {ckpt} and no step dirs")
        ckpt = latest
    cfg_json = os.path.join(ckpt, "config.json")
    if os.path.isfile(cfg_json):
        with open(cfg_json) as f:
            cfg = cfg_lib.VLMConfig.from_json(f.read())
    else:
        cfg = getattr(cfg_lib, args.config_preset)()
    sd = torch.load(os.path.join(ckpt, "params.pt"), map_location="cpu")
    lora = None
    if args.lora_base:
        lora, base = lora_from_state_dict(sd, device), args.lora_base
        if os.path.isfile(os.path.join(base, "params.pt")):
            model = model_from_state_dict(
                torch.load(os.path.join(base, "params.pt"),
                           map_location="cpu"), cfg, device)
        else:
            model = load_safetensors_checkpoint(base, cfg, torch.float32,
                                                device=device)
    else:
        model = model_from_state_dict(sd, cfg, device)

    os.makedirs(args.out, exist_ok=True)
    if args.hf_template:
        for name in os.listdir(args.hf_template):
            if name.endswith((".safetensors", ".bin", ".index.json")):
                continue
            src = os.path.join(args.hf_template, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(args.out, name))
    sd = export_torch_state_dict(model, cfg, lora=lora)
    out_file = os.path.join(args.out, "model.safetensors")
    save_safetensors(sd, out_file, args.dtype)
    print(f"wrote {out_file} ({len(sd)} tensors, {args.dtype})")
    return out_file


if __name__ == "__main__":
    main()
