"""Ambient sharding context (port of ``v2pe_tpu/parallel/context.py``).

The model code stays mesh-agnostic; the trainer or the eval harness
activates a :class:`ShardingContext` and every ``flash_attention`` call
routes through ``parallel/shard_attn.py``, the tensor-parallel layers find
their group here, and the loss its reduction axes.

The JAX context holds a ``jax.sharding.Mesh``. The port's holds:

* ``mesh``: the ``torch.distributed`` ``DeviceMesh`` of a process group,
  one process a card, axes (data, fsdp, seq, tensor)
  (``parallel/bootstrap.py:make_global_mesh``); None in a process without
  a group;
* ``seq_shards``: ring shards held by this one process, all on its card
  (a world of 1 only): the ring's shards in training, the paged pool's
  shards in serving;
* ``ring_mode``: 'scan' or 'fused'.

Serving reads one number, :attr:`ShardingContext.pool_shards`: the shards
of the paged pool's page axis, ``seq_shards`` on one card or the ``seq``
axis across processes (the other is 1), as JAX reads
``mesh.shape["seq"]``; and :attr:`ShardingContext.pool_shard`, the shard a
process's pool holds (None on one card, which holds them all).

``pipe`` above 1 raises ``NotImplementedError``, and so does a mesh that
does not match the world, and the fused ring across processes.

:func:`use_sharding` sets the process's context, which every thread reads
(autograd's device threads too, where a checkpointed forward is recomputed
under it). :func:`use_sharding_on_thread` sets one for the calling thread
alone, over the process's: a server's scheduler thread steps under the
context its engine was built in, and no other thread sees it."""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    seq_shards: int = 1
    ring_mode: str = "scan"  # 'scan' (one flash call per hop and shard,
    # merged by lse) | 'fused' (one launch sweeps every hop,
    # parallel/ring_fused.py)
    mesh: Optional[Any] = None  # DeviceMesh (data, fsdp, seq, tensor)

    def __post_init__(self):
        if self.seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got "
                             f"{self.seq_shards}")
        if self.ring_mode not in ("scan", "fused"):
            raise ValueError(f"unknown ring_mode {self.ring_mode!r} "
                             "(expected 'scan' or 'fused')")
        if self.mesh is not None and self.seq_shards > 1 \
                and self.mesh.size() > 1:
            raise ValueError("ring shards on one card (seq_shards) are for "
                             "a world of 1; across ranks the mesh's seq axis "
                             "holds them")
        if self.ring_mode == "fused" and self.size("seq") > 1:
            raise NotImplementedError(
                "--ring_mode fused across processes: the fused ring's chunk "
                "table points at local memory only (ROADMAP Queue 1 item "
                "6.5; Queue 2, '#11 across cards'); use --ring_mode scan")

    @property
    def pipe_shards(self) -> int:
        """Size of the pipeline axis: the port has none, which counts as
        1."""
        return 1

    @property
    def pool_shards(self) -> int:
        """Shards of a paged pool's page axis (JAX: ``seq_shards``)."""
        return self.seq_shards * self.size("seq")

    @property
    def pool_shard(self) -> Optional[int]:
        """The pool shard this process holds; None when it holds all."""
        return self.coord("seq") if self.size("seq") > 1 else None

    def size(self, axis: str) -> int:
        """Ranks along a mesh axis (1 without a mesh)."""
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    def coord(self, axis: str) -> int:
        """This rank's index along a mesh axis."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along a mesh axis."""
        return self.mesh.get_group(axis)

    @property
    def dp_index(self) -> int:
        """This rank's (data, fsdp) coordinate: which rows it holds."""
        return self.coord("data") * self.size("fsdp") + self.coord("fsdp")

    @property
    def dp_size(self) -> int:
        return self.size("data") * self.size("fsdp")

    def all_reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum ``t`` in place over the named axes (those above 1)."""
        import torch.distributed as dist

        for a in axes:
            if self.size(a) > 1:
                dist.all_reduce(t, group=self.group(a))
        return t

    @classmethod
    def from_mesh(cls, mesh_cfg, ring_mode: str = "scan"
                  ) -> "ShardingContext":
        """The context of a ``MeshConfig``. Under a process group its axes
        must multiply to the world size (one process a card) and the
        context carries the global ``DeviceMesh``; in a world of 1,
        ``seq`` above 1 keeps its shards on the one card. Any other mesh
        above 1 raises ``NotImplementedError``: it never runs as one
        process."""
        from v2pe_tpu_torch.parallel import bootstrap

        if mesh_cfg.pipe > 1:
            raise NotImplementedError(
                "the pipe axis (parallel/pipeline.py) is not ported "
                "(ROADMAP Queue 1 item 8, the next after Queue 1 item 6)")
        world = bootstrap.world_size()
        if world > 1:
            return cls(ring_mode=ring_mode,
                       mesh=bootstrap.make_global_mesh(mesh_cfg))
        other = {a: getattr(mesh_cfg, a)
                 for a in ("data", "fsdp", "tensor")
                 if getattr(mesh_cfg, a) > 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other} need {mesh_cfg.num_devices} processes "
                f"under torch.distributed, one a card; this is a world of "
                f"1 (ROADMAP Queue 1 item 6: launch one process a card, "
                f"parallel/bootstrap.py)")
        import torch.distributed as dist

        mesh = None
        if dist.is_initialized():  # a world of 1 under a process group
            mesh = bootstrap.make_global_mesh(type(mesh_cfg)())
        return cls(seq_shards=mesh_cfg.seq, ring_mode=ring_mode, mesh=mesh)


_CURRENT: Optional[ShardingContext] = None
_THREAD = threading.local()   # .ctx: a thread's own, over _CURRENT
_UNSET = object()


def current() -> Optional[ShardingContext]:
    ctx = getattr(_THREAD, "ctx", _UNSET)
    return _CURRENT if ctx is _UNSET else ctx


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev


@contextlib.contextmanager
def use_sharding_on_thread(ctx: Optional[ShardingContext]):
    """``ctx`` (None too) for the calling thread alone: the process's
    context and every other thread's are left as they are."""
    prev = getattr(_THREAD, "ctx", _UNSET)
    _THREAD.ctx = ctx
    try:
        yield ctx
    finally:
        _THREAD.ctx = prev
