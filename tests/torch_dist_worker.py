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

import torch

torch.set_num_threads(1)


def _ctx(mesh: dict, ring_mode: str = "scan"):
    from v2pe_tpu_torch.core.config import MeshConfig
    from v2pe_tpu_torch.parallel.context import ShardingContext

    return ShardingContext.from_mesh(MeshConfig(**mesh), ring_mode=ring_mode)


def _cfg(spec):
    from v2pe_tpu_torch.core.config import VLMConfig

    return VLMConfig.from_json(spec["cfg"])


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

    cfg = _cfg(spec)
    if task.get("drop_path_rate"):
        cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, drop_path_rate=task["drop_path_rate"]))
    ctx = _ctx(task["mesh"])
    model = from_jax_params(spec["tree"], cfg, mesh=ctx)
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
            "ring_q_shapes": sorted(set(calls))}


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
    return {"unbroken": unbroken, "resumed": resumed, "step": at,
            "data_state": data_state, "files": sorted(os.listdir(path)),
            "params": full}


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
        "int8 adam, fsdp": lambda: build_optimizer(
            TrainConfig(use_8bit_optimizer=True),
            from_jax_params(spec["tree"], cfg, mesh=_ctx({"fsdp": world})),
            cfg),
        "compress-seq": lambda: _compress(spec, cfg, world),
    }
    out = {}
    for what, fn in calls.items():
        try:
            fn()
            out[what] = None
        except Exception as e:  # the test reads the type and message
            out[what] = (type(e).__name__, str(e))
    # int8 Adam stays exact under data alone: it builds
    build_optimizer(TrainConfig(use_8bit_optimizer=True),
                    from_jax_params(spec["tree"], cfg,
                                    mesh=_ctx({"data": world})), cfg)
    return out


def _compress(spec, cfg, world):
    from v2pe_tpu_torch.models.compress_seq import init_compress_params
    from v2pe_tpu_torch.models.params import from_jax_params
    from v2pe_tpu_torch.parallel.mesh import shard_model

    model = from_jax_params(spec["tree"], cfg)
    model.compress = init_compress_params(model.llm, cfg=cfg.llm,
                                          fuse_method="add")
    shard_model(model, cfg, _ctx({"fsdp": world}))


TASKS = {"train": task_train, "resume": task_resume,
         "ulysses": task_ulysses, "ring": task_ring,
         "drop_path": task_drop_path,
         "refusals": task_refusals}


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
