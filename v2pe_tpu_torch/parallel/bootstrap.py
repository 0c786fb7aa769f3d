"""Multi-process bootstrap (port of ``v2pe_tpu/parallel/bootstrap.py``):
launcher detection, the ``torch.distributed`` process group, the global
``DeviceMesh`` and the placement of each rank's batch.

One process drives one card. The JAX package starts one
``jax.distributed`` runtime whose processes each hold many devices; here
``init_process_group`` joins one process a card (NCCL on ``cuda``, gloo on
``cpu``), and a ``DeviceMesh`` over all ranks carries the axes of a
``MeshConfig`` with ``data`` outermost, as ``make_global_mesh`` lays them
out in the JAX package.

Launcher detection order (``detect_env``; the JAX package's order, with
the PyTorch runtime's own launcher where JAX autodetects a TPU pod):

1. explicit env ``V2PE_NUM_PROCESSES`` / ``V2PE_PROCESS_ID`` /
   ``V2PE_COORDINATOR`` (``host:port``, or a ``file://`` / ``tcp://`` URL
   for ``init_process_group``);
2. SLURM (``SLURM_PROCID`` / ``SLURM_NTASKS`` / ``SLURM_STEP_NODELIST``);
3. OpenMPI (``OMPI_COMM_WORLD_RANK`` / ``_SIZE``);
4. torchrun (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``
   / ``MASTER_PORT``);
5. none: one process, no process group.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

AXES = ("data", "fsdp", "seq", "tensor")

# DeviceMeshes built so far, by (shape, device type): building one creates
# process groups, a collective call on every rank
_MESHES: dict = {}
# the device type of this process's ranks ("type"), set when it joins
_DEVICE: dict = {}


@dataclasses.dataclass(frozen=True)
class DistEnv:
    launcher: str            # 'env' | 'slurm' | 'mpi' | 'torchrun' | 'none'
    process_id: int
    num_processes: int
    coordinator: Optional[str]  # host:port or an init URL; None for none
    local_rank: int = 0      # the card of this process on its host


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist like 'node[3-5,9],other' (the
    analogue of ``scontrol show hostname | head -n1``)."""
    m = re.match(r"([^\[,]+)(\[([^\]]+)\])?", nodelist)
    prefix = m.group(1)
    if not m.group(2):
        return prefix
    first = m.group(3).split(",")[0].split("-")[0]
    return prefix + first


def detect_env(coordinator_port: int = 8476) -> DistEnv:
    """Inspect the environment for a launcher, without side effects."""
    env = os.environ
    if "V2PE_NUM_PROCESSES" in env:
        pid = int(env.get("V2PE_PROCESS_ID", "0"))
        return DistEnv(
            launcher="env", process_id=pid,
            num_processes=int(env["V2PE_NUM_PROCESSES"]),
            coordinator=env.get("V2PE_COORDINATOR",
                                f"127.0.0.1:{coordinator_port}"),
            local_rank=int(env.get("LOCAL_RANK", pid)))
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        host = _first_slurm_node(env.get("SLURM_STEP_NODELIST",
                                         env.get("SLURM_NODELIST", "")))
        return DistEnv(
            launcher="slurm", process_id=int(env["SLURM_PROCID"]),
            num_processes=int(env["SLURM_NTASKS"]),
            coordinator=f"{host}:{coordinator_port}",
            local_rank=int(env.get("SLURM_LOCALID", "0")))
    if "OMPI_COMM_WORLD_RANK" in env \
            and int(env.get("OMPI_COMM_WORLD_SIZE", "1")) > 1:
        return DistEnv(
            launcher="mpi", process_id=int(env["OMPI_COMM_WORLD_RANK"]),
            num_processes=int(env["OMPI_COMM_WORLD_SIZE"]),
            coordinator=env.get("V2PE_COORDINATOR",
                                f"127.0.0.1:{coordinator_port}"),
            local_rank=int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")))
    if "RANK" in env and "WORLD_SIZE" in env:
        return DistEnv(
            launcher="torchrun", process_id=int(env["RANK"]),
            num_processes=int(env["WORLD_SIZE"]),
            coordinator=f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                        f"{env.get('MASTER_PORT', coordinator_port)}",
            local_rank=int(env.get("LOCAL_RANK", "0")))
    return DistEnv(launcher="none", process_id=0, num_processes=1,
                   coordinator=None)


def _init_url(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_distributed(launcher: str = "auto",
                           coordinator_port: int = 8476,
                           device: str = "cuda",
                           init_method: Optional[str] = None,
                           backend: Optional[str] = None) -> DistEnv:
    """Join the process group a launcher describes (or ``launcher``
    forces): NCCL on ``cuda``, after ``torch.cuda.set_device(local_rank)``;
    gloo on ``cpu``. ``backend="gloo"`` on ``cuda`` lets several ranks
    share a card (rank r on card ``local_rank % cards``; NCCL refuses a
    second rank on a device), their collectives staged through the host. A
    single process without ``init_method`` starts no group.
    ``init_method`` (a ``file://`` URL, say) starts one even in a world of
    1. Idempotent."""
    denv = detect_env(coordinator_port)
    if launcher != "auto":
        denv = dataclasses.replace(denv, launcher=launcher)
    if init_method is None and (denv.launcher == "none"
                                or denv.num_processes == 1):
        return denv
    if dist.is_initialized():
        return denv
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        torch.cuda.set_device(denv.local_rank % torch.cuda.device_count()
                              if backend == "gloo" else denv.local_rank)
    url = init_method or _init_url(denv.coordinator or
                                   f"127.0.0.1:{coordinator_port}")
    dist.init_process_group(backend, init_method=url,
                            world_size=denv.num_processes,
                            rank=denv.process_id)
    _DEVICE["type"] = "cuda" if device == "cuda" else "cpu"
    logger.info("torch.distributed up: launcher=%s rank %d/%d (%s)",
                denv.launcher, dist.get_rank(), dist.get_world_size(),
                dist.get_backend())
    return denv


def shutdown() -> None:
    """Leave the process group and forget the meshes built on it."""
    _MESHES.clear()
    _DEVICE.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks of the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_global_mesh(cfg):
    """The ``DeviceMesh`` of a ``MeshConfig`` over every rank: axes
    (data, fsdp, seq, tensor), ``data`` outermost, rank r at the
    coordinate of r in that row-major order. The mesh must cover the whole
    world: a rank outside it would hold no shard."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (cfg.data, cfg.fsdp, cfg.seq, cfg.tensor)
    n = int(np.prod(shape))
    if n != world_size():
        raise NotImplementedError(
            f"the mesh {dict(zip(AXES, shape))} covers {n} cards, the "
            f"process group has {world_size()} ranks: one process drives "
            f"one card (ROADMAP Queue 1 item 6)")
    device_type = _DEVICE.get("type") or (
        "cuda" if dist.get_backend() == "nccl" else "cpu")
    key = (shape, device_type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, shape,
                                        mesh_dim_names=AXES)
    return _MESHES[key]


# --------------------------------------------------------------------------
# Per-rank batch placement
# --------------------------------------------------------------------------

# the train-step batch contract (train/train_step.py): (B, S) arrays split
# their rows over (data, fsdp) and their tokens over seq; the flat tile
# stack splits over (data, fsdp) only
SEQ_KEYS = ("input_ids", "rope_pos_ids", "token_positions", "segment_ids",
            "targets", "labels", "loss_weight", "vit_gather_idx")
TILE_KEYS = ("pixel_values", "image_flags")


def rows_of_global_batch(batch: dict, index: int, count: int,
                         vit_rows_per_tile: int) -> dict:
    """The rows of one (data, fsdp) coordinate out of a global batch: the
    inverse of JAX's ``make_global_batch``, which concatenates the
    coordinates' batches row-major and their tile stacks likewise, with
    ``vit_gather_idx`` shifted by the tiles before. Every coordinate holds
    as many rows and tiles."""
    unknown = [k for k in batch if k not in SEQ_KEYS + TILE_KEYS]
    if unknown:
        raise ValueError(f"batch keys {unknown} have no sharding contract")
    B = np.shape(batch["input_ids"])[0]
    T = np.shape(batch["pixel_values"])[0] if "pixel_values" in batch else 0
    if B % count or T % count:
        raise ValueError(f"{B} rows and {T} tiles do not split over "
                         f"{count} (data, fsdp) coordinates")
    rows = slice(index * B // count, (index + 1) * B // count)
    tiles = slice(index * T // count, (index + 1) * T // count)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        v = v[rows] if k in SEQ_KEYS else v[tiles]
        if k == "vit_gather_idx":
            off = tiles.start * vit_rows_per_tile
            v = np.where(v >= 0, v - off, v)
        out[k] = v
    return out


def make_global_batch(batch: dict, ctx, device) -> dict:
    """Place a rank's batch: ``batch`` holds the rows of its (data, fsdp)
    coordinate (packed by this rank, or ``rows_of_global_batch``), with
    every sequence in the layout of the whole ``seq`` axis (zigzag-permuted
    by ``collate_rows(seq_shards=n)``); the rank keeps its contiguous
    ``seq`` shard of the tokens and all the tiles, on ``device``."""
    n = 1 if ctx is None else ctx.size("seq")
    r = 0 if ctx is None else ctx.coord("seq")
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if n > 1 and k in SEQ_KEYS:
            S = t.shape[1]
            if S % n:
                raise ValueError(f"{k}: {S} tokens do not split over "
                                 f"{n} seq ranks")
            t = t[:, r * S // n:(r + 1) * S // n]
        out[k] = t.contiguous().to(device, non_blocking=True)
    return out
