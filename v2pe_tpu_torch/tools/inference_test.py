"""One image, one question, one answer (counterpart of
``tools/inference_test.py``, the reference's ``pretrained/inference_test.py``):
load a checkpoint through the eval CLI's loader
(``evalkit/cli.py:load_chat_model``: an HF safetensors directory, or a
step directory of the port's trainer), tile the image, print the greedy
answer. Runs on the card unless ``--platform cpu``:

    python -m v2pe_tpu_torch.tools.inference_test --checkpoint DIR \
        --tokenizer <tokenizer dir> --image photo.jpg \
        [--question "Please describe the image shortly."] \
        [--weights-dtype int8|int4] [--platform cpu]
"""

from __future__ import annotations

import argparse


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--question",
                   default="Please describe the image shortly.")
    p.add_argument("--config-preset", default="internvl2_2b")
    p.add_argument("--max-num", type=int, default=12)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--rope_pos_id_version", default=None)
    p.add_argument("--rope_pos_id_stride", type=int, default=None)
    p.add_argument("--weights-dtype", default=None,
                   choices=["int8", "int4"],
                   help="weight-only quantized decoder")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default) or, only when asked, the CPU")
    return p


def main(argv=None, tokenizer=None) -> str:
    """Print the tiling and the exchange; return the answer.
    ``tokenizer``: used as it is in place of loading ``--tokenizer``."""
    args = build_argparser().parse_args(argv)
    from v2pe_tpu_torch.data.datasets import load_image
    from v2pe_tpu_torch.evalkit.cli import load_chat_model
    from v2pe_tpu_torch.infer.generate import GenerationConfig

    model = load_chat_model(args, tokenizer)
    pixels, n_tiles = model.load_pixels(load_image(args.image),
                                        max_num=args.max_num)
    size = model.cfg.force_image_size or model.cfg.vision.image_size
    print(f"tiled into {n_tiles} x {size}x{size} patches")
    response = model.chat(
        pixels, args.question,
        GenerationConfig(max_new_tokens=args.max_new_tokens),
        num_patches_list=[n_tiles],
        rope_pos_id_version=args.rope_pos_id_version,
        rope_pos_id_stride=args.rope_pos_id_stride)
    print(f"User: {args.question}\nAssistant: {response}")
    return response


if __name__ == "__main__":
    main()
