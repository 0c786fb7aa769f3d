"""Benchmark evaluation CLI (port of ``v2pe_tpu/evalkit/cli.py``).

Counterpart of the reference's per-benchmark torchrun scripts
(``scripts/evaluate*.sh`` + ``eval/<bench>/eval_*.py``): one entry point,
sharded by --rank/--world (the reference used torchrun ranks), resumable via
answered-id skip sets, with the checkpoint's V2PE settings overridable by
``--rope_pos_id_version/--rope_pos_id_stride`` (STRIDE env parity).

The model runs on the CUDA card (``--platform cuda``, the default, raises
when there is none); ``--platform cpu`` runs it on the CPU. A checkpoint
is an HF safetensors directory (read by the port's own reader) or a step
directory of the port's trainer (``params.pt``). ``main(argv,
tokenizer=...)`` and ``load_chat_model(args, tokenizer=...)`` take a
tokenizer object in place of loading ``--tokenizer`` with
``AutoTokenizer``.

Example:
  python -m v2pe_tpu_torch.evalkit.cli --benchmark mm_niah \
      --checkpoint /path/to/ckpt --config-preset internvl2_2b \
      --tokenizer internlm/internlm2-chat-1_8b \
      --data questions.jsonl --outputs-dir out/ --task retrieval-text-test
"""

from __future__ import annotations

import argparse
import json
import logging
import os


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--benchmark", required=True,
                   choices=["mm_niah", "milebench", "longvqa", "vqa",
                            "mmmu", "mmbench", "pope", "scienceqa", "seed",
                            "video", "videomme", "mvbench", "mlvu",
                            "nextqa", "lvbench", "longvideobench",
                            "perceptiontest", "hourvideo", "highres_qa",
                            "activitynet", "msrvtt", "msvd", "tgif"])
    p.add_argument("--checkpoint", required=True,
                   help="step dir of the port's trainer (params.pt) or HF "
                        "safetensors dir")
    p.add_argument("--config-preset", default="internvl2_2b")
    p.add_argument("--tokenizer", required=True,
                   help="HF tokenizer name or path (a tokenizer object "
                        "handed to main() is used in its place)")
    p.add_argument("--platform", default="cuda",
                   choices=["cpu", "cuda", "gpu"],
                   help="the device to run the model on: the CUDA card "
                        "(default; raises when there is none) or, only "
                        "when asked for, the CPU")
    p.add_argument("--data", required=True, help="questions jsonl")
    p.add_argument("--outputs-dir", required=True)
    p.add_argument("--task", default="test")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world", type=int, default=1)
    p.add_argument("--max-num", type=int, default=-1,
                   help="tile budget per image (-1 = benchmark default: 12, "
                        "or the per-task table for --benchmark vqa)")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--num-beams", type=int, default=1,
                   help="beam search width (the reference's SEED "
                        "--num-beams, evaluate_seed.py:264)")
    p.add_argument("--weights-dtype", default=None,
                   choices=["int8", "int4"],
                   help="int8: weight-only quantized serving "
                        "(ops/quantized_matmul.py)")
    p.add_argument("--rope_pos_id_version", default=None)
    p.add_argument("--rope_pos_id_stride", type=int,
                   default=int(os.environ.get("STRIDE", 0)) or None)
    p.add_argument("--score-only", action="store_true")
    # general-suite extras
    p.add_argument("--language", default="en", choices=["en", "cn"],
                   help="mmbench instruction language")
    p.add_argument("--pope-label-dir", default=None,
                   help="dir of coco_pope_<category>.json label files")
    p.add_argument("--data-root", default=None,
                   help="image/video root (milebench, video, vqa, longvqa)")
    p.add_argument("--annotation", default=None,
                   help="official annotations json (vqa_score/anls scoring)")
    p.add_argument("--judge-client", default=None,
                   help="module:callable judge for open-ended video QA "
                        "(messages -> response str); scoring is skipped "
                        "when absent and only outputs are written")
    p.add_argument("--engine-rows", type=int, default=0,
                   help=">0: batch samples through the continuous-batching "
                        "engine with this many concurrent rows (greedy "
                        "only; excludes --num-beams > 1). The reference "
                        "evaluates strictly one sample at a time")
    p.add_argument("--engine-max-len", type=int, default=8192,
                   help="per-row prompt+generation capacity when "
                        "--engine-rows is set")
    p.add_argument("--num-frames", type=int, default=16,
                   help="video suite frames per clip")
    p.add_argument("--frame-sample", default="middle",
                   help="frame sampling: rand | middle | fpsX.Y "
                        "(dataset.py:35-71 parity)")
    return p


def load_chat_model(args, tokenizer=None, stack=None):
    """The ChatModel of ``args.checkpoint`` (an ``EngineChat`` over it with
    ``--engine-rows``). ``tokenizer``: used as it is in place of loading
    ``--tokenizer``. ``stack``: a ``contextlib.ExitStack`` that takes the
    engine's stop (without one, the stop is registered with ``atexit``)."""
    import dataclasses

    import torch

    from v2pe_tpu_torch.core import config as cfg_lib
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.models.params import (load_safetensors_checkpoint,
                                              model_from_state_dict)

    device = {"gpu": "cuda"}.get(args.platform, args.platform)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform cuda: no CUDA device is available; "
                           "pass --platform cpu to evaluate on the CPU")
    cfg = getattr(cfg_lib, args.config_preset)()
    # the trainer persists the full pipeline config with each checkpoint
    # (config.json — the reference's PretrainedConfig analogue); prefer it
    # over the preset so eval reads rope_pos_id_stride etc. from the
    # checkpoint (eval_milebench.py:226-230 behavior). Explicit CLI flags
    # still override below.
    # A config.json in an HF-hub snapshot (InternVLChatConfig.to_dict())
    # is detected by shape and bridged (core/config.py:vlm_config_from_hf)
    ckpt_cfg = os.path.join(args.checkpoint, "config.json")
    if os.path.isfile(ckpt_cfg):
        from v2pe_tpu_torch.core.config import load_vlm_config

        cfg = load_vlm_config(ckpt_cfg)
    if args.rope_pos_id_version:
        cfg = dataclasses.replace(cfg,
                                  rope_pos_id_version=args.rope_pos_id_version)
    if args.rope_pos_id_stride:
        cfg = dataclasses.replace(cfg,
                                  rope_pos_id_stride=args.rope_pos_id_stride)

    if tokenizer is None:
        from transformers import AutoTokenizer

        from v2pe_tpu_torch.data.constants import SPECIAL_TOKENS

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer,
                                                  trust_remote_code=True)
        tokenizer.add_tokens(list(SPECIAL_TOKENS), special_tokens=True)

    params_pt = os.path.join(args.checkpoint, "params.pt")
    if os.path.isfile(params_pt):
        params = model_from_state_dict(
            torch.load(params_pt, map_location="cpu"), cfg, device)
    else:
        params = load_safetensors_checkpoint(args.checkpoint, cfg,
                                             torch.bfloat16, device)
    model = ChatModel(params, cfg, tokenizer,
                      weights_dtype=getattr(args, "weights_dtype", None))
    rows = getattr(args, "engine_rows", 0)
    if rows > 0:
        if getattr(args, "num_beams", 1) > 1:
            raise SystemExit("--engine-rows batches greedy decodes; "
                             "it cannot combine with --num-beams > 1")
        import atexit

        from v2pe_tpu_torch.serve.engine import EngineChat

        model = EngineChat(model, max_rows=rows,
                           max_len=getattr(args, "engine_max_len", 8192))
        # main()'s routes return from many places; the scheduler daemon
        # and its pool must not outlive the run
        (stack.callback if stack is not None else atexit.register)(
            model.stop)
    return model


def main(argv=None, tokenizer=None):
    logging.basicConfig(level=logging.INFO)
    args = build_argparser().parse_args(argv)
    os.makedirs(args.outputs_dir, exist_ok=True)
    import contextlib

    with contextlib.ExitStack() as stack:
        _run(args, tokenizer, stack)


def _run(args, tokenizer, stack):
    vqa_auto_tiles = args.max_num < 0  # per-task table (evaluate_auto.sh)
    if args.max_num < 0:
        args.max_num = 12

    if args.benchmark == "mm_niah":
        from v2pe_tpu_torch.evalkit import mm_niah, runner

        if args.score_only:
            print(json.dumps(mm_niah.score_directory(args.outputs_dir),
                             indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        infer = mm_niah.build_infer_fn(
            model, max_tiles=args.max_num,
            rope_pos_id_version=args.rope_pos_id_version,
            rope_pos_id_stride=args.rope_pos_id_stride,
            generation_config=GenerationConfig(
                max_new_tokens=args.max_new_tokens,
                num_beams=args.num_beams),
            data_root=args.data_root or os.path.dirname(args.data))
        items = [json.loads(l) for l in open(args.data)]
        out = os.path.join(args.outputs_dir,
                           f"model_{args.task}.rank{args.rank}.jsonl")
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            merged = os.path.join(args.outputs_dir,
                                  f"model_{args.task}.jsonl")
            runner.merge_shards([out], merged)
            print(json.dumps(mm_niah.score_jsonl(merged, args.task),
                             indent=2))
    elif args.benchmark in ("mmmu", "mmbench", "pope", "scienceqa", "seed"):
        from v2pe_tpu_torch.evalkit import general, mmbench, runner

        def _score(merged):
            label_files = None
            if args.benchmark == "pope" and args.pope_label_dir:
                label_files = {
                    f[10:-5]: os.path.join(args.pope_label_dir, f)
                    for f in os.listdir(args.pope_label_dir)
                    if f.startswith("coco_pope_")}
            return general.score_file(args.benchmark, merged,
                                      pope_label_files=label_files)

        merged = os.path.join(args.outputs_dir, f"{args.benchmark}.jsonl")
        if args.score_only:
            print(json.dumps(_score(merged), indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        infer = general.build_infer_fn(
            args.benchmark, model, max_tiles=args.max_num,
            language=args.language,
            rope_pos_id_version=args.rope_pos_id_version,
            rope_pos_id_stride=args.rope_pos_id_stride,
            generation_config=GenerationConfig(
                max_new_tokens=args.max_new_tokens,
                num_beams=args.num_beams))
        if args.data.endswith(".tsv"):  # mmbench distribution format
            items = mmbench.read_tsv(args.data)
        else:
            items = [json.loads(l) for l in open(args.data)]
        out = os.path.join(args.outputs_dir,
                           f"{args.benchmark}.rank{args.rank}.jsonl")
        id_key = general.ID_KEYS[args.benchmark]
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world, id_key=id_key,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            runner.merge_shards([out], merged, id_key=id_key)
            if args.benchmark == "mmbench":
                sub = os.path.join(args.outputs_dir,
                                   "mmbench_submission.jsonl")
                outputs = [json.loads(l) for l in open(merged)]
                mmbench.write_submission(items, outputs, sub)
                logging.info("submission -> %s", sub)
            print(json.dumps(_score(merged), indent=2))
    elif args.benchmark == "milebench":
        from v2pe_tpu_torch.evalkit import milebench, milebench_adapter, runner

        merged = os.path.join(args.outputs_dir, f"{args.task}.jsonl")
        if args.score_only:
            preds = [json.loads(l) for l in open(merged)]
            print(json.dumps(milebench.evaluate_multichoice(preds), indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        infer = milebench_adapter.build_infer_fn(
            model, data_root=args.data_root or os.path.dirname(args.data),
            max_tiles_total=args.max_num,
            rope_pos_id_version=args.rope_pos_id_version,
            rope_pos_id_stride=args.rope_pos_id_stride,
            generation_config=GenerationConfig(
                max_new_tokens=args.max_new_tokens,
                num_beams=args.num_beams))
        items = [json.loads(l) for l in open(args.data)]
        out = os.path.join(args.outputs_dir,
                           f"{args.task}.rank{args.rank}.jsonl")
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            preds = runner.merge_shards([out], merged)
            print(json.dumps(milebench.evaluate_multichoice(preds), indent=2))
    elif args.benchmark in ("video", "videomme", "mvbench", "mlvu",
                            "nextqa", "lvbench", "longvideobench",
                            "perceptiontest", "hourvideo", "highres_qa"):
        from v2pe_tpu_torch.evalkit import runner, video

        merged = os.path.join(args.outputs_dir, f"{args.task}.jsonl")

        def _vscore(results):
            if args.benchmark == "video":
                return video.score(results)
            return video.score_buckets(
                results, video.VIDEO_BUCKET_KEYS[args.benchmark])

        if args.score_only:
            results = [json.loads(l) for l in open(merged)]
            print(json.dumps(_vscore(results), indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        gc = GenerationConfig(max_new_tokens=args.max_new_tokens,
                              num_beams=args.num_beams)
        root = args.data_root or os.path.dirname(args.data)
        if args.benchmark == "video":
            infer = video.build_infer_fn(
                model, data_root=root, num_frames=args.num_frames,
                rope_pos_id_version=args.rope_pos_id_version,
                rope_pos_id_stride=args.rope_pos_id_stride,
                generation_config=gc)
        else:
            infer = video.build_mc_video_infer_fn(
                args.benchmark, model, data_root=root,
                num_frames=args.num_frames, sample=args.frame_sample,
                rope_pos_id_version=args.rope_pos_id_version,
                rope_pos_id_stride=args.rope_pos_id_stride,
                generation_config=gc)
        if args.benchmark == "hourvideo" and args.data.endswith(".json"):
            items = video.hourvideo_flatten(json.load(open(args.data)))
        else:
            items = [json.loads(l) for l in open(args.data)]
        out = os.path.join(args.outputs_dir,
                           f"{args.task}.rank{args.rank}.jsonl")
        vid_key = "question_id" if args.benchmark == "videomme" else "id"
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world, id_key=vid_key,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            results = runner.merge_shards([out], merged, id_key=vid_key)
            if args.benchmark == "hourvideo":
                sub = os.path.join(args.outputs_dir,
                                   f"{args.task}_submission.json")
                json.dump(video.hourvideo_fold(results), open(sub, "w"))
                logging.info("submission -> %s", sub)
            print(json.dumps(_vscore(results), indent=2))
    elif args.benchmark in ("activitynet", "msrvtt", "msvd", "tgif"):
        from v2pe_tpu_torch.evalkit import gpt_judge, runner, video

        merged = os.path.join(args.outputs_dir, f"{args.task}.jsonl")

        def _judge_and_score(results):
            if not args.judge_client:
                logging.info("no --judge-client: wrote outputs only "
                             "(GPT-judge scoring needs a client)")
                return {"n": len(results), "judged": False}
            import importlib

            mod_name, fn_name = args.judge_client.split(":")
            client = getattr(importlib.import_module(mod_name), fn_name)
            # task-scoped artifacts: run_generation_benchmark resumes
            # from and combines ALL jsons in its results dir, so sharing
            # one dir across benchmarks would skip samples and merge
            # foreign judgments into the summary
            combined = gpt_judge.run_generation_benchmark(
                results,
                os.path.join(args.outputs_dir,
                             f"eval_results_{args.benchmark}"),
                os.path.join(args.outputs_dir,
                             f"gpt_eval_results_{args.benchmark}.json"),
                client)
            return gpt_judge.summarize(combined)

        if args.score_only:
            results = [json.loads(l) for l in open(merged)]
            print(json.dumps(_judge_and_score(results), indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        infer = video.build_open_ended_infer_fn(
            args.benchmark, model,
            data_root=args.data_root or os.path.dirname(args.data),
            num_frames=args.num_frames, sample=args.frame_sample,
            rope_pos_id_version=args.rope_pos_id_version,
            rope_pos_id_stride=args.rope_pos_id_stride,
            generation_config=GenerationConfig(
                max_new_tokens=args.max_new_tokens,
                num_beams=args.num_beams))
        items = [json.loads(l) for l in open(args.data)]
        for i, it in enumerate(items):  # runner resumes by 'id'
            it.setdefault("id", it.get("question_id",
                                       it.get("video_name", i)))
        out = os.path.join(args.outputs_dir,
                           f"{args.task}.rank{args.rank}.jsonl")
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            results = runner.merge_shards([out], merged)
            print(json.dumps(_judge_and_score(results), indent=2))
    elif args.benchmark == "vqa":
        from v2pe_tpu_torch.evalkit import runner, vqa_driver

        ds_name = args.task  # e.g. chartqa_test_human (evaluate_vqa.py:21)
        merged = os.path.join(args.outputs_dir, f"{ds_name}.jsonl")
        if args.score_only:
            outputs = [json.loads(l) for l in open(merged)]
            print(json.dumps(vqa_driver.score_outputs(
                ds_name, outputs, annotation_file=args.annotation), indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        if ds_name not in vqa_driver.DS_COLLECTIONS:
            raise SystemExit(
                f"unknown vqa dataset {ds_name!r}; known: "
                f"{sorted(vqa_driver.DS_COLLECTIONS)}")
        mnt = vqa_driver.DS_COLLECTIONS[ds_name]["max_new_tokens"]
        infer = vqa_driver.build_infer_fn(
            ds_name, model,
            max_tiles=None if vqa_auto_tiles else args.max_num,
            rope_pos_id_version=args.rope_pos_id_version,
            rope_pos_id_stride=args.rope_pos_id_stride,
            generation_config=GenerationConfig(max_new_tokens=mnt,
                num_beams=args.num_beams),
            image_root=args.data_root or "")
        items = [json.loads(l) for l in open(args.data)]
        for it in items:  # runner resumes by 'id'
            it.setdefault("id", it["question_id"])
        out = os.path.join(args.outputs_dir,
                           f"{ds_name}.rank{args.rank}.jsonl")
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            outputs = runner.merge_shards([out], merged)
            print(json.dumps(vqa_driver.score_outputs(
                ds_name, outputs, annotation_file=args.annotation), indent=2))
    elif args.benchmark == "longvqa":
        from v2pe_tpu_torch.evalkit import longvqa_driver, runner

        task = args.task  # chartqa / docvqa / ... (task2token keys)
        merged = os.path.join(args.outputs_dir, f"result_{task}.jsonl")
        if args.score_only:
            results = [json.loads(l) for l in open(merged)]
            print(json.dumps(longvqa_driver.score_results(task, results),
                             indent=2))
            return
        model = load_chat_model(args, tokenizer, stack)
        from v2pe_tpu_torch.infer.generate import GenerationConfig

        mnt = longvqa_driver.TASK2TOKEN.get(task, args.max_new_tokens)
        infer = longvqa_driver.build_infer_fn(
            task, model, image_root=args.data_root or "",
            max_tiles=args.max_num,
            rope_pos_id_version=args.rope_pos_id_version,
            rope_pos_id_stride=args.rope_pos_id_stride,
            generation_config=GenerationConfig(max_new_tokens=mnt,
                num_beams=args.num_beams))
        items = [json.loads(l) for l in open(args.data)]
        out = os.path.join(args.outputs_dir,
                           f"result_{task}.rank{args.rank}.jsonl")
        n = runner.run_shard(items, infer, out, rank=args.rank,
                             world=args.world,
                             workers=max(1, args.engine_rows))
        logging.info("answered %d items -> %s", n, out)
        if args.rank == 0 and args.world == 1:
            results = runner.merge_shards([out], merged)
            score_path = os.path.join(args.outputs_dir,
                                      f"score_{task}.json")
            score = longvqa_driver.score_results(task, results)
            json.dump(score, open(score_path, "w"), indent=4)
            print(json.dumps(score, indent=2))
    else:
        raise SystemExit(f"unknown benchmark {args.benchmark}")


if __name__ == "__main__":
    main()
