"""One rank of a multi-process run of the port, over gloo on the CPU.

Started by ``tests/torch_dist.py`` (``Run``) once per rank, with
``V2PE_NUM_PROCESSES`` / ``V2PE_PROCESS_ID`` / ``V2PE_COORDINATOR`` (a
``file://`` store) in its environment:

    python -m tests.torch_dist_worker SPEC

``SPEC`` is a pickle of ``{"tasks": [...], ...}``; each task runs in order
and rank 0 writes what they return to ``SPEC + ".out"``. Imports torch and
the port only (no jax).
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)


def _ctx(mesh: dict, ring_mode: str = "scan"):
    from v2pe_tpu_torch.core.config import MeshConfig
    from v2pe_tpu_torch.parallel.context import ShardingContext

    return ShardingContext.from_mesh(MeshConfig(**mesh), ring_mode=ring_mode)


def _cfg(spec, task=None):
    """The run's config (a task's own where it has one)."""
    from v2pe_tpu_torch.core.config import VLMConfig

    return VLMConfig.from_json((task or {}).get("cfg", spec["cfg"]))


def _local_batch(batch, ctx, cfg):
    from v2pe_tpu_torch.parallel.bootstrap import (make_global_batch,
                                                   rows_of_global_batch)

    rows = rows_of_global_batch(batch, ctx.dp_index, ctx.dp_size,
                                cfg.num_image_token)
    return make_global_batch(rows, ctx, "cpu")


def _setup(spec, task):
    import dataclasses

    from v2pe_tpu_torch.core.config import MeshConfig
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer
    from v2pe_tpu_torch.train.train_step import make_train_step

    cfg = _cfg(spec, task)
    if task.get("drop_path_rate"):
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, drop_path_rate=task["drop_path_rate"]))
    ctx = _ctx(task["mesh"])
    model = from_jax_params(task.get("tree", spec["tree"]), cfg, mesh=ctx)
    opt = build_optimizer(TrainConfig(**task["tc"]), model, cfg)
    step = make_train_step(cfg, opt, MeshConfig(**task["mesh"]),
                           img_context_token_id=spec["img_context_id"],
                           remat=task.get("remat", "full"))
    return cfg, ctx, model, opt, step


def task_train(spec, task):
    """Steps of ``make_train_step`` on the spec's global batches: the
    losses, grad norms, and the parameters after them (whole)."""
    from v2pe_tpu_torch.parallel import shard_attn

    cfg, ctx, model, opt, step = _setup(spec, task)
    state = opt.init()
    ring = shard_attn.dist_ring_flash_attention
    calls = []
    shard_attn.dist_ring_flash_attention = \
        lambda *a: calls.append(a[2].shape) or ring(*a)
    losses, norms = [], []
    for i, batch in enumerate(spec["batches"]):
        gen = None
        if task.get("drop_path_rate"):  # the trainer's DropPath stream
            from v2pe_tpu_torch.train.trainer import _dp_generator

            gen = _dp_generator(0, i, "cpu")
        loss, gnorm = step(model, state, _local_batch(batch, ctx, cfg), gen)
        losses.append(float(loss))
        norms.append(float(gnorm))
    shard_attn.dist_ring_flash_attention = ring
    full = model.placement.full_state_dict(model)
    return {"loss": losses, "grad_norm": norms,
            "params": {n: t.numpy() for n, t in full.items()},
            "rules": sorted(model.placement.rules),
            "ring_q_shapes": sorted(set(calls)),
            **_int8_state(model, state)}


def _int8_state(model, state) -> dict:
    """An int8 Adam state gathered to one device's layout, and the bytes
    of it each rank holds (rank order); nothing for another optimizer."""
    import torch.distributed as dist

    if "moments" not in state:
        return {}
    mine = sum(t.numel() * t.element_size()
               for mom in state["moments"].values() for t in mom.values())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    whole = model.placement.gather_state(model, state)["moments"]
    return {"moments": {k: {t: v.cpu().numpy() for t, v in mom.items()}
                        for k, mom in whole.items()},
            "state_bytes": every}


def task_lora(spec, task):
    """LoRA steps on a mesh: the spec's whole base and adapters (a JAX
    adapter tree), placed by ``place_lora``; the losses, grad norms, the
    adapters after the steps (whole), their split, and whether the base
    stayed as it was."""
    from v2pe_tpu_torch.core.config import MeshConfig
    from v2pe_tpu_torch.models.lora import from_jax_lora
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.parallel.mesh import place_lora
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer
    from v2pe_tpu_torch.train.train_step import make_train_step

    cfg, ctx = _cfg(spec, task), _ctx(task["mesh"])
    model = from_jax_params(spec["tree"], cfg)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    lora = from_jax_lora(spec["adapters"])
    view = place_lora(model, lora, cfg, ctx)
    opt = build_optimizer(TrainConfig(**task["tc"]), lora, cfg)
    step = make_train_step(cfg, opt, MeshConfig(**task["mesh"]),
                           img_context_token_id=spec["img_context_id"],
                           remat=task.get("remat", "full"), lora=True)
    state = opt.init()
    losses, norms = [], []
    for batch in spec["batches"]:
        loss, gnorm = step(lora, state, _local_batch(batch, ctx, cfg), view)
        losses.append(float(loss))
        norms.append(float(gnorm))
    return {"loss": losses, "grad_norm": norms,
            "adapters": {n: t.numpy() for n, t in
                         lora.placement.full_state_dict(lora).items()},
            "rules": sorted(lora.placement.rules),
            "partial": sorted(lora.placement.partial),
            "base_unchanged": all(torch.equal(t, before[n]) for n, t in
                                  model.state_dict().items())}


def task_int8_opt(spec, task):
    """int8 Adam on a placed model, fed the spec's whole gradients (each
    rank its shards of them): the parameters after the steps, the state
    gathered, each rank's bytes of it."""
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer

    cfg, ctx = _cfg(spec), _ctx(task["mesh"])
    model = from_jax_params(spec["tree"], cfg, mesh=ctx)
    opt = build_optimizer(TrainConfig(**task["tc"]), model, cfg)
    state = opt.init()
    pl, params = model.placement, dict(model.named_parameters())
    for grads in spec["grads"]:
        opt.step({n: pl._shard(n, torch.from_numpy(np.array(g)),
                               params[n]).contiguous()
                  for n, g in grads.items()}, state)
    full = pl.full_state_dict(model)
    return {"params": {n: t.numpy() for n, t in full.items()},
            **_int8_state(model, state)}


def task_resume(spec, task):
    """Step 1, save, step 2 (the unbroken run); then a fresh model restored
    from the save takes step 2 again."""
    from v2pe_tpu_torch.core import checkpoint as ckpt

    cfg, ctx, model, opt, step = _setup(spec, task)
    state = opt.init()
    b1, b2 = (_local_batch(b, ctx, cfg) for b in spec["batches"][:2])
    step(model, state, b1)
    path = ckpt.save_checkpoint(task["dir"], 1, model, state,
                                data_state={"rank": ctx.coord("fsdp")})
    unbroken = float(step(model, state, b2)[0])
    cfg, ctx, model2, opt2, step2 = _setup(spec, task)
    state2 = opt2.init()
    model2, state2, at, data_state = ckpt.restore_checkpoint(path, model2,
                                                             state2)
    resumed = float(step2(model2, state2, b2)[0])
    full = {n: t.numpy() for n, t in
            model2.placement.full_state_dict(model2).items()}
    out = {"unbroken": unbroken, "resumed": resumed, "step": at,
           "data_state": data_state, "files": sorted(os.listdir(path)),
           "params": full}
    if task.get("compare"):  # the unbroken run's state beside the resumed
        out["unbroken_params"] = {
            n: t.numpy() for n, t in
            model.placement.full_state_dict(model).items()}
        out["unbroken_moments"] = _int8_state(model, state).get("moments")
        out["resumed_moments"] = _int8_state(model2, state2).get("moments")
    return out


def task_ulysses(spec, task):
    """Ulysses over all_to_all (each rank its contiguous shard) against
    the world-1 form on the whole tensors: outputs and input gradients."""
    import torch.distributed as dist

    from v2pe_tpu_torch.parallel.ulysses import ulysses_attention

    n, r = dist.get_world_size(), dist.get_rank()
    g = torch.Generator().manual_seed(0)
    B, S, Hq, Hkv, D = 2, 64, 4, 2, 16
    q, k, v = (torch.randn(B, S, h, D, generator=g) for h in (Hq, Hkv, Hkv))
    seg = torch.ones(B, S, dtype=torch.int32)
    seg[1, 40:] = 2
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    w = torch.randn(B, S, Hq, D, generator=g)

    def run(q, k, v, ids, group):
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        out = ulysses_attention(q, k, v, seq_shards=n, q_segment_ids=ids[0],
                                kv_segment_ids=ids[0], q_positions=ids[1],
                                kv_positions=ids[1], group=group)
        return out, torch.autograd.grad((out * w_local(group)).sum(),
                                        (q, k, v))

    rows = slice(r * S // n, (r + 1) * S // n)

    def w_local(group):
        return w if group is None else w[:, rows]

    shard = lambda t: t[:, rows].contiguous()  # noqa: E731
    out, grads = run(*(shard(t) for t in (q, k, v)),
                     (shard(seg), shard(pos)), dist.group.WORLD)
    ref, ref_grads = run(q, k, v, (seg, pos), None)
    errs = [float((out - ref[:, rows]).abs().max())] + [
        float((a - b[:, rows]).abs().max()) for a, b in zip(grads,
                                                            ref_grads)]
    got = torch.tensor(errs)
    dist.all_reduce(got, op=dist.ReduceOp.MAX)
    return {"errors": got.tolist()}


def task_ring(spec, task):
    """The scan ring across the ranks (each its zigzag shard, chunks by
    P2P) against the ring with every shard on one card: outputs and
    gradients of this rank's rows, the largest difference over ranks."""
    import torch.distributed as dist

    from v2pe_tpu_torch.parallel import ring

    n, r = dist.get_world_size(), dist.get_rank()
    g = torch.Generator().manual_seed(1)
    B, S, Hq, Hkv, D = 2, 128 * n, 4, 2, 16
    q, k, v = (torch.randn(B, S, h, D, generator=g) for h in (Hq, Hkv, Hkv))
    seg = torch.ones(B, S, dtype=torch.int32)
    seg[0, S // 3:] = 2
    seg[1, -S // 5:] = 0  # a padded tail
    zig = lambda t: torch.cat([ring.zigzag_shard(t, i, n) for i in range(n)],
                              dim=1).contiguous()  # noqa: E731
    pos = zig(torch.arange(S, dtype=torch.int32).expand(B, S))
    q, k, v, seg = zig(q), zig(k), zig(v), zig(seg)
    w = torch.randn(B, S, Hq, D, generator=g)
    statics = ring.RingStatics(causal=True, scale=D ** -0.5)
    rows = slice(r * S // n, (r + 1) * S // n)

    def run(fn, ts, wt):
        ts = [t.clone().requires_grad_() for t in ts]
        out = fn(*ts)
        return out, torch.autograd.grad((out * wt).sum(), ts)

    mine = [t[:, rows].contiguous() for t in (seg, pos)]
    out, grads = run(lambda q_, k_, v_: ring.dist_ring_flash_attention(
        dist.group.WORLD, statics, q_, k_, v_, mine[0], mine[0], mine[1],
        mine[1]), [t[:, rows].contiguous() for t in (q, k, v)], w[:, rows])
    ref, ref_grads = run(lambda q_, k_, v_: ring.ring_flash_attention(
        n, statics, q_, k_, v_, seg, seg, pos, pos), [q, k, v], w)
    errs = torch.tensor([float((out - ref[:, rows]).abs().max())] + [
        float((a - b[:, rows]).abs().max()) for a, b in zip(grads,
                                                            ref_grads)])
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return {"errors": errs.tolist()}


def task_drop_path(spec, task):
    """The ViT features of every rank's tiles under DropPath (the step's
    generator, rate 0.1) on a data axis, gathered in rank order."""
    import dataclasses

    import torch.distributed as dist

    from v2pe_tpu_torch.models.internvl_chat import extract_feature
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.parallel.bootstrap import rows_of_global_batch
    from v2pe_tpu_torch.parallel.context import use_sharding
    from v2pe_tpu_torch.train.trainer import _dp_generator

    cfg = _cfg(spec)
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, drop_path_rate=0.1))
    ctx = _ctx(task["mesh"])
    model = from_jax_params(spec["tree"], cfg)
    rows = rows_of_global_batch(spec["batches"][0], ctx.dp_index,
                                ctx.dp_size, cfg.num_image_token)
    with use_sharding(ctx), torch.no_grad():
        feats = extract_feature(model, cfg,
                                torch.from_numpy(rows["pixel_values"]),
                                drop_path_generator=_dp_generator(0, 0,
                                                                  "cpu"))
    every = [torch.empty_like(feats) for _ in range(dist.get_world_size())]
    dist.all_gather(every, feats)
    return {"features": torch.cat(every).numpy()}


def task_refusals(spec, task):
    """What a mesh of processes refuses: each call's exception type."""
    from v2pe_tpu_torch.core.config import MeshConfig
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.train.optimizer import TrainConfig, build_optimizer

    cfg = _cfg(spec)
    world = int(os.environ["V2PE_NUM_PROCESSES"])
    calls = {
        "mismatched world": lambda: _ctx({"fsdp": 2 * world}),
        "pipe": lambda: _ctx({"fsdp": world, "pipe": 2}),
        "fused ring across ranks": lambda: _ctx({"seq": world},
                                                ring_mode="fused"),
        "compress-seq over seq": lambda: _compress(spec, cfg, world),
    }
    out = {}
    for what, fn in calls.items():
        try:
            fn()
            out[what] = None
        except Exception as e:  # the test reads the type and message
            out[what] = (type(e).__name__, str(e))
    # int8 Adam builds under data alone and over sharded leaves
    for axis in ("data", "fsdp"):
        build_optimizer(TrainConfig(use_8bit_optimizer=True),
                        from_jax_params(spec["tree"], cfg,
                                        mesh=_ctx({axis: world})), cfg)
    return out


def _compress(spec, cfg, world):
    """A compress-seq model placed on a seq mesh (the placement takes it),
    then its forward under the mesh's context (refused)."""
    from v2pe_tpu_torch.models.compress_seq import (compress_llm_forward,
                                                    init_compress_params)
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.parallel.context import use_sharding
    from v2pe_tpu_torch.parallel.mesh import shard_model

    model = from_jax_params(spec["tree"], cfg)
    model.compress = init_compress_params(model.llm, cfg=cfg.llm,
                                          fuse_method="add")
    ctx = _ctx({"seq": world})
    shard_model(model, cfg, ctx)
    x = torch.zeros(1, 8, cfg.llm.hidden_size)
    with use_sharding(ctx):
        compress_llm_forward(model.llm, model.compress, cfg.llm, x,
                             torch.zeros(1, 8), 4)


# ---------------------------------------------------------------- serving


def _served(spec, task, ctx):
    """The spec's fp32 model, its decoder quantized first when the task says
    (``bits``, ``group_size``), placed on ``ctx`` by ``shard_model``."""
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.parallel.mesh import shard_model

    cfg = _cfg(spec)
    model = from_jax_params(spec["tree"], cfg)
    if task.get("bits"):
        from v2pe_tpu_torch.models.internvl_chat import with_llm
        from v2pe_tpu_torch.ops.quantized_matmul import quantize_llm_params

        model = with_llm(model, quantize_llm_params(
            model.llm, task["bits"], task.get("group_size", 128)))
    return cfg, shard_model(model, cfg, ctx, serving=True)


def _paged_steps(model, cfg, ids):
    """The paged serving path step by step on (B, S) ids at positions
    0..S-1: a 20-token prefill into empty pages, an 18-token chunk over the
    history, a 5-token verify step across a page boundary (pages of 8),
    then single-token decode steps; the fp32 logits of each step, and the
    shape of this rank's pool."""
    from v2pe_tpu_torch.infer import paged_kv as pk
    from v2pe_tpu_torch.infer.chunked_prefill import chunked_prefill
    from v2pe_tpu_torch.infer.generate import paged_prefill_cache
    from v2pe_tpu_torch.models.internlm2 import llm_forward, local_kv_heads

    llm, lc = model.llm, cfg.llm
    ids = torch.from_numpy(ids)
    B, S = ids.shape
    cache = paged_prefill_cache(lc, B, 64, 8, None, torch.float32, "cpu",
                                kv_heads=local_kv_heads(llm, lc))
    pos = torch.arange(S, dtype=torch.float32).expand(B, S)
    out, at = [], 0
    for n in (20, 18, 5) + (1,) * (S - 43):
        sl = slice(at, at + n)
        if n == 18:
            logits, cache = chunked_prefill(llm, lc, cache,
                                            input_ids=ids[:, sl],
                                            rope_pos_ids=pos[:, sl])
        else:
            step = torch.full((B,), n, dtype=torch.int32)
            cache = pk.allocate_rows(cache, step)
            logits, cache = llm_forward(llm, lc, input_ids=ids[:, sl],
                                        rope_pos_ids=pos[:, sl],
                                        paged_cache=cache)
            cache = pk.advance_lengths(cache, step)
        out.append(logits.numpy())
        at += n
    return {"logits": out, "pool": tuple(cache.k_pages.shape),
            "shards": cache.n_shards}


def _chat(spec, model, cfg):
    from transformers import PreTrainedTokenizerFast

    from v2pe_tpu_torch.infer.chat import ChatModel

    tok = PreTrainedTokenizerFast.from_pretrained(spec["tokenizer"])
    return ChatModel(model, cfg, tok, cache_mode="paged", page_size=4)


def task_serve(spec, task):
    """Serving under a mesh: each check of ``task["checks"]`` on the spec's
    model placed on it, every rank's results gathered in rank order (the
    ranks must agree: each ran the same scheduler on the same requests)."""
    import torch.distributed as dist

    from v2pe_tpu_torch.infer.generate import GenerationConfig, generate
    from v2pe_tpu_torch.parallel.context import use_sharding
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    ctx = _ctx(task["mesh"])
    cfg, model = _served(spec, task, ctx)
    out = {}
    with use_sharding(ctx), torch.no_grad():
        for check in task["checks"]:
            if check == "layers":
                out[check] = _paged_steps(model, cfg, spec["ids"])
            elif check in ("paged", "dense", "speculative"):
                gc = GenerationConfig(max_new_tokens=6, speculative_k=3
                                      if check == "speculative" else 0)
                toks, _, lens = generate(
                    model, cfg, gc,
                    *[torch.from_numpy(x) for x in spec["gen_batch"]],
                    spec["img_context_id"], page_size=4,
                    cache_mode="dense" if check == "dense" else "paged")
                out[check] = (toks.numpy(), lens.numpy())
            elif check == "engine":
                eng = InferenceEngine(
                    _chat(spec, model, cfg), max_rows=2, max_len=64,
                    page_size=4, chunk_size=16, decode_block=4,
                    generation_config=GenerationConfig(
                        max_new_tokens=6, eos_token_ids=(1,)))
                reqs = [eng.submit(p, np.arange(len(p), dtype=np.float32),
                                   max_new_tokens=6)
                        for p in spec["prompts"]]
                eng.run_until_idle()
                out[check] = {"tokens": [r.tokens for r in reqs],
                              "pool": tuple(eng.cache.k_pages.shape),
                              "shards": eng.cache.n_shards,
                              "stats": dict(eng.stats)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    return every


TASKS = {"train": task_train, "resume": task_resume,
         "int8_opt": task_int8_opt, "lora": task_lora,
         "ulysses": task_ulysses, "ring": task_ring,
         "drop_path": task_drop_path,
         "refusals": task_refusals, "serve": task_serve}


def main(path: str) -> int:
    from v2pe_tpu_torch.parallel import bootstrap

    with open(path, "rb") as f:
        spec = pickle.load(f)
    bootstrap.initialize_distributed(device="cpu")
    rank = torch.distributed.get_rank()
    try:
        out = [TASKS[t["kind"]](spec, t) for t in spec["tasks"]]
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # a peer waiting in a collective must not hang us
    if rank == 0:
        with open(path + ".out.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".out.tmp", path + ".out")
    bootstrap.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
