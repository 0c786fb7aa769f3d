"""Whether two processes on one CUDA card form a process group that FSDP2
accepts: for each backend (NCCL, then gloo), two ranks on ``cuda:0`` place
a small two-layer model with ``fully_shard`` over both and take one
forward and backward; each rank prints what happened (or the error's first
line). Imports torch only; run on a machine with one card:

    python -m tests.torch_two_ranks_one_card
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp


def _rank(rank: int, backend: str, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch import nn

    lines = []
    try:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=2)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        mesh = init_device_mesh("cuda", (2,))
        model = nn.Sequential(nn.Linear(64, 64), nn.Linear(64, 8)).cuda()
        for layer in model:
            fully_shard(layer, mesh=mesh)
        fully_shard(model, mesh=mesh)
        x = torch.randn(4, 64, device="cuda", generator=torch.Generator(
            "cuda").manual_seed(rank))
        model(x).square().sum().backward()
        torch.cuda.synchronize()
        g = model[0].weight.grad
        lines.append(f"{backend} rank {rank}: fully_shard over 2 ranks on "
                     f"cuda:0 ran a forward and backward; local grad shard "
                     f"{tuple(g.to_local().shape)}")
    except Exception as e:  # the probe records the refusal
        first = str(e).strip().splitlines()[0] if str(e).strip() else ""
        lines.append(f"{backend} rank {rank}: {type(e).__name__}: "
                     f"{first[:300]}")
    finally:
        try:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001 -- the group may be broken
            pass
        with open(f"{out}.{rank}", "w") as f:
            f.write("\n".join(lines) + "\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    for backend in ("nccl", "gloo"):
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=_rank, args=(
                r, backend, f"{tmp}/store", f"{tmp}/out")) for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(timeout=120)
                if p.is_alive():
                    p.kill()
                    p.join()
            for r in range(2):
                path = f"{tmp}/out.{r}"
                print(open(path).read().strip() if os.path.exists(path)
                      else f"{backend} rank {r}: no result (exit "
                      f"{procs[r].exitcode})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
