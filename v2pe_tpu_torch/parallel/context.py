"""Ambient sharding context (port of ``v2pe_tpu/parallel/context.py``).

The model code stays mesh-agnostic; the trainer or the eval harness
activates a :class:`ShardingContext` and every ``flash_attention`` call
routes through ``parallel/shard_attn.py`` (ring attention when the seq axis
is above 1).

The JAX context holds a ``jax.sharding.Mesh``; the port's holds the size of
the one axis it has, ``seq``, whose shards all live on one card, and the
ring's mode. Every other axis above 1 raises ``NotImplementedError``
(ROADMAP Queue 1 item 6: the mesh, the transport between cards, FSDP and
tensor rules)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShardingContext:
    seq_shards: int = 1
    ring_mode: str = "scan"  # 'scan' (one flash call per hop and shard,
    # merged by lse) | 'fused' (one launch sweeps every hop,
    # parallel/ring_fused.py)

    def __post_init__(self):
        if self.seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got "
                             f"{self.seq_shards}")
        if self.ring_mode not in ("scan", "fused"):
            raise ValueError(f"unknown ring_mode {self.ring_mode!r} "
                             "(expected 'scan' or 'fused')")

    @property
    def pipe_shards(self) -> int:
        """Size of the pipeline axis: the port has none, which counts as
        1."""
        return 1

    @classmethod
    def from_mesh(cls, mesh_cfg, ring_mode: str = "scan"
                  ) -> "ShardingContext":
        """The context of a ``MeshConfig``: its ``seq`` axis; any other
        axis above 1 raises ``NotImplementedError``."""
        other = {a: getattr(mesh_cfg, a)
                 for a in ("data", "fsdp", "tensor", "pipe")
                 if getattr(mesh_cfg, a) > 1}
        if other:
            raise NotImplementedError(
                f"mesh axes {other} are not ported: only 'seq' is, with its "
                f"shards on one card (ROADMAP Queue 1 item 6)")
        return cls(seq_shards=mesh_cfg.seq, ring_mode=ring_mode)


_CURRENT: Optional[ShardingContext] = None


def current() -> Optional[ShardingContext]:
    return _CURRENT


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield ctx
    finally:
        _CURRENT = prev
