"""Pipeline parallelism (GPipe) over the ``pipe`` axis of a mesh of
processes. Port of ``v2pe_tpu/parallel/pipeline.py``.

The JAX package shards the stacked decoder layers' leading L dim over
``pipe`` and runs the GPipe ticks as one SPMD program under ``shard_map``;
``jax.grad`` transposes the tick scan. Here each rank is a process that
holds only its stage's L / P contiguous decoder layers
(``parallel/mesh.py:shard_model``), and the schedule is explicit:

* the batch is split into M microbatches (:func:`choose_microbatches` of
  the global batch, with dp = data x fsdp; each rank splits the rows of
  its (data, fsdp) coordinate into M, so M must divide them);
* stage s runs microbatch m at tick m + s (M + P - 1 ticks, bubble
  (P - 1) / (M + P - 1)): it takes microbatch m from stage s - 1 (stage 0
  from its own input), runs its layers and hands the activations one hop
  on to stage s + 1, in the compute dtype. There is no wrap edge;
* only the last stage keeps the outputs, in an fp32 buffer that is then
  made whole on every pipe rank (JAX's ``psum`` over ``pipe``, in which
  only the last stage's term is not zero: here a broadcast from it). The
  final norm, the head and the loss then run on every pipe rank, as JAX
  runs them replicated.

The backward is not left to autograd across ranks: each rank's engine may
order the independent microbatch chains differently, and a send / receive
pair would then deadlock. :class:`_Pipeline` wraps the stage stack in one
``torch.autograd.Function``. Its forward runs the ticks with autograd on
and keeps each microbatch's stage input (a detached leaf) and output; its
backward runs them in reverse, in an explicit loop: receive the output's
gradient from stage s + 1 (the last stage takes its own), backpropagate
through the microbatch's stage graph, send the input's gradient to stage
s - 1. The gradient of the stage input is then made whole on every pipe
rank from stage 0 (JAX's transpose of the replicated input: a sum over
``pipe`` whose only term that is not zero is stage 0's), so the ViT and
the embedding of every pipe rank see the same gradient.

Remat: JAX checkpoints each layer of a stage for every truthy ``remat``
(``jax.checkpoint`` around the layer body), so under ``pipe`` 'block2',
'block4' and 'attn_saved' become per-layer checkpointing. The port keeps
that as JAX has it and logs it once.

Composition: pipe x data x fsdp x tensor, as in JAX. Inside a stage the
attention takes the plain flash path (``seq`` is 1 under ``pipe``, which
is what JAX's ``use_sharding(None)`` gives there); the context stays
active so that a stage's tensor-split layers find their group, and FSDP2
gathers a stage's layers over ``fsdp`` through the layers' own calls.

Transport: the hops are ``torch.distributed`` sends and receives on the
``pipe`` group. gloo moves no CUDA tensor point to point, so on gloo a
CUDA hop is staged through host memory (``bootstrap.host_staged``); that
is the transport of two ranks on one card, not a fallback of the device.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional

import torch
import torch.distributed as dist

from v2pe_tpu_torch.parallel import context as pctx
from v2pe_tpu_torch.parallel.bootstrap import host_staged

_logger = logging.getLogger(__name__)
_REMAT_LOGGED: set = set()


def choose_microbatches(batch: int, n_pipe: int, requested: int = 0,
                        dp: int = 1) -> int:
    """Microbatch count: the requested value, else the largest divisor of
    ``batch`` that is <= 2 * n_pipe (more microbatches shrink the bubble;
    past ~2P the returns vanish while per-microbatch matmuls shrink).

    ``dp``: the data-parallel extent batch rows are sharded over. Divisors
    where the per-microbatch row count stays divisible by ``dp`` are
    preferred — otherwise the microbatch activations must replicate over
    the batch axes inside the stage (see ``pipeline_llm_layers``)."""
    if requested:
        if batch % requested:
            raise ValueError(
                f"pipe_microbatches={requested} must divide batch={batch}")
        return requested
    best = 1
    for m in range(min(batch, 2 * n_pipe), 0, -1):
        if batch % m == 0:
            if (batch // m) % dp == 0:
                if m == 1 and n_pipe > 1:
                    # B rows already spread 1-per-dp-group: microbatching
                    # below one row per group would idle dp groups, so the
                    # schedule degenerates to sequential model parallelism
                    # (bubble (P-1)/P). Surface it — the fix is a larger
                    # global batch or explicit --pipe_microbatches.
                    _logger.warning(
                        "pipeline: batch=%d over dp=%d leaves 1 microbatch "
                        "— no overlap across %d stages (bubble %.0f%%); "
                        "grow the batch or set pipe_microbatches",
                        batch, dp, n_pipe, 100 * (n_pipe - 1) / n_pipe)
                return m
            best = max(best, m) if best == 1 else best
    return best


def stage_range(ctx: "pctx.ShardingContext", n_layers: int) -> range:
    """The decoder layers of this rank's pipe stage: L / P contiguous
    layers (JAX's sharding of the stacked L dim over ``pipe``)."""
    n_pipe = ctx.pipe_shards
    if n_layers % n_pipe:
        raise ValueError(f"layers {n_layers} % pipe {n_pipe} != 0")
    per = n_layers // n_pipe
    s = ctx.coord("pipe")
    return range(s * per, (s + 1) * per)


def bubble(n_pipe: int, microbatches: int) -> float:
    """The idle share of the GPipe schedule, (P - 1) / (M + P - 1)."""
    return (n_pipe - 1) / (microbatches + n_pipe - 1)


def _stage_remat(remat) -> str:
    """The remat of a stage's layers: per layer for every truthy mode,
    as JAX's stage body checkpoints each layer."""
    if remat in (False, None, "none"):
        return "none"
    if remat not in (True, "full") and remat not in _REMAT_LOGGED:
        _REMAT_LOGGED.add(remat)
        _logger.info("pipeline: remat %r runs as per-layer checkpointing "
                     "inside a stage, as JAX's pipeline does", remat)
    return "full"


class _Hops:
    """The point-to-point hops of one rank on the ``pipe`` group: to and
    from the neighbouring stages, staged through the host where the
    backend cannot move the device's tensors (gloo and CUDA)."""

    def __init__(self, ctx, device):
        self.group = ctx.group("pipe")
        me, n = ctx.coord("pipe"), ctx.pipe_shards
        self.prev = dist.get_global_rank(self.group, me - 1) if me else None
        self.next = dist.get_global_rank(self.group, me + 1) \
            if me < n - 1 else None
        self.last = dist.get_global_rank(self.group, n - 1)
        self.first = dist.get_global_rank(self.group, 0)
        self.device = device
        self.staged = host_staged(self.group, device)
        self.pending = []

    def send(self, t: torch.Tensor, dst: int, tag: int) -> None:
        buf = t.detach().contiguous()
        if self.staged:
            buf = buf.cpu()
        # the buffer stays referenced until the request has completed
        self.pending.append((dist.isend(buf, dst, group=self.group, tag=tag),
                             buf))

    def recv(self, shape, dtype, src: int, tag: int) -> torch.Tensor:
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if self.staged else self.device)
        dist.recv(buf, src, group=self.group, tag=tag)
        return buf.to(self.device)

    def flush(self) -> None:
        for req, _ in self.pending:
            req.wait()
        self.pending = []

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of rank ``src`` on every pipe rank (in place)."""
        buf = t.cpu() if self.staged else t
        dist.broadcast(buf, src, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t


class _Schedule:
    """One call of the pipelined stage stack: the microbatches' inputs
    and what runs them through this rank's layers."""

    def __init__(self, layers, cfg, ctx, x, cos, sin, segment_ids,
                 positions, rope_pack, remat):
        self.cfg = cfg
        self.n_pipe, self.stage = ctx.pipe_shards, ctx.coord("pipe")
        B = x.shape[0]
        self.layers = [layers[i] for i in stage_range(ctx, len(layers))]
        # JAX's count, of the global batch; each rank splits its own rows
        # (the decoder mixes no rows, so which rows share a microbatch
        # changes nothing)
        self.M = choose_microbatches(B * ctx.dp_size, self.n_pipe,
                                     ctx.pipe_microbatches, dp=ctx.dp_size)
        if B % self.M:
            raise ValueError(
                f"{self.M} pipe microbatches do not split the {B} rows of "
                f"a (data, fsdp) coordinate: each rank splits its own rows")
        self.remat = _stage_remat(remat)
        split = lambda t: None if t is None else t.reshape(  # noqa: E731
            (self.M, B // self.M) + tuple(t.shape[1:]))
        self.cos, self.sin = split(cos), split(sin)
        self.seg, self.pos = split(segment_ids), split(positions)
        rope_ids, self.theta = rope_pack if rope_pack is not None \
            else (None, 0.0)
        self.rid = split(rope_ids)
        self.mb_shape = (B // self.M,) + tuple(x.shape[1:])
        self.dtype = x.dtype
        self.hops = _Hops(ctx, x.device)

    def run_stage(self, m: int, x: torch.Tensor) -> torch.Tensor:
        from v2pe_tpu_torch.models.internlm2 import _train_layers

        take = lambda t: None if t is None else t[m]  # noqa: E731
        rid = take(self.rid)
        return _train_layers(
            self.layers, self.cfg, x, take(self.cos), take(self.sin),
            self.remat, segment_ids=take(self.seg), positions=take(self.pos),
            rope_pack=(rid, self.theta) if rid is not None else None)

    def forward(self, x: torch.Tensor, keep: Optional[list]):
        """The forward ticks; ``keep`` (with a backward to come) receives
        each microbatch's (stage input leaf, stage output). Returns the
        whole output (B, S, D) in the compute dtype on every pipe rank."""
        h, last = self.hops, self.stage == self.n_pipe - 1
        xs = x.reshape((self.M,) + self.mb_shape)
        out = torch.zeros((self.M,) + self.mb_shape, dtype=torch.float32,
                          device=x.device)
        grad = torch.enable_grad() if keep is not None \
            else contextlib.nullcontext()
        for m in range(self.M):
            inp = xs[m] if self.stage == 0 else \
                h.recv(self.mb_shape, self.dtype, h.prev, tag=0)
            if keep is not None:
                inp = inp.detach().requires_grad_()
            with grad:
                y = self.run_stage(m, inp)
            if last:
                out[m] = y.detach().float()
            else:
                h.send(y, h.next, tag=0)
            if keep is not None:
                keep.append((inp, y))
        h.flush()
        h.broadcast(out, h.last)
        return out.reshape(x.shape).to(self.dtype)

    def backward(self, kept: list, g: torch.Tensor) -> torch.Tensor:
        """The backward ticks in reverse; returns the gradient of the stage
        input, whole on every pipe rank."""
        h = self.hops
        gs = g.reshape((self.M,) + self.mb_shape)
        dx = torch.zeros((self.M,) + self.mb_shape, dtype=torch.float32,
                         device=g.device)
        for m in reversed(range(self.M)):
            inp, y = kept[m]
            gy = gs[m] if self.stage == self.n_pipe - 1 else \
                h.recv(self.mb_shape, y.dtype, h.next, tag=1)
            torch.autograd.backward(y, gy.to(y.dtype))
            gin = inp.grad if inp.grad is not None else torch.zeros_like(inp)
            if self.stage == 0:
                dx[m] = gin.float()
            else:
                h.send(gin, h.prev, tag=1)
            kept[m] = None  # the microbatch's graph goes with it
        h.flush()
        h.broadcast(dx, h.first)
        return dx.reshape(g.shape).to(g.dtype)


class _Pipeline(torch.autograd.Function):
    """The stage stack under one autograd node; ``anchor`` (a leaf that
    requires grad) makes the node part of the graph even when the stage
    input does not require grad (a frozen embedding under LoRA)."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x, anchor):
        ctx.sched, ctx.kept = sched, []
        return sched.forward(x, ctx.kept)

    @staticmethod
    def backward(ctx, g):
        dx = ctx.sched.backward(ctx.kept, g)
        ctx.kept = None
        return None, dx, None


def pipeline_llm_layers(layers, cfg, x: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, *,
                        segment_ids: Optional[torch.Tensor],
                        positions: Optional[torch.Tensor],
                        rope_pack: Optional[tuple],
                        ctx: "pctx.ShardingContext", remat=True):
    """Run the decoder layers GPipe-pipelined over ``ctx``'s pipe axis.
    Semantically the plain layer stack of ``llm_forward``; the batch must
    split into the microbatches. ``layers``: the model's ``nn.ModuleList``
    of all L layers, of which this rank holds and runs its stage's
    (``stage_range``). ``x``: (B, S, D) hidden states, the same on every
    pipe rank. Returns the layers' output (B, S, D), whole on every pipe
    rank; differentiable when autograd is on."""
    if ctx.seq_shards > 1 or ctx.size("seq") > 1:
        raise ValueError("pipeline parallelism does not compose with ring "
                         "SP (seq must be 1)")
    sched = _Schedule(layers, cfg, ctx, x, cos, sin, segment_ids, positions,
                      rope_pack, remat)
    if not torch.is_grad_enabled():
        return sched.forward(x, None)
    anchor = torch.empty(0, device=x.device, requires_grad=True)
    return _Pipeline.apply(sched, x, anchor)
