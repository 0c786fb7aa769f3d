"""Weight-only int8 / int4 linear layers for serving.

Port of ``v2pe_tpu/ops/quantized_matmul.py``, in its layouts, so a JAX
quantized tree crosses over as numpy without repacking.

int8 (``QuantizedWeight``): per-output-channel symmetric codes,

    w ~= q * scale,  q int8 (..., D, Npad),  scale fp32 (..., 1, Npad)

with ``scale = amax_D(|w|) / 127``. The scale commutes out of the
contraction, so the product is ``dot(x, q) * scale``.

int4 (``Int4Weight``): symmetric codes in [-7, 7] per group of
``group_size`` contracted rows and output channel, two to a byte: byte
``p[d]`` holds row ``d`` in its low nibble and row ``d + D/2`` in its high
nibble, so unpacking gives the two contiguous halves of the weight; scale
fp32 ``(..., D / group_size, Npad)``. Group scales do not commute out, so
each weight is dequantized (nibble x scale, rounded to bf16) before the
product, which runs as two half-depth products.

N is zero-padded to a multiple of 128 at quantize time (codes 0, scale 1);
``n_out`` keeps the true width and the product returns only those columns.

Arithmetic of the product, in the kernels and in their plain versions: x
rounded to bf16 whatever the model's dtype, codes (or dequantized int4
weights) as bf16, products accumulated in fp32, the int8 scale applied
after the contraction, the result cast to ``out_dtype``.

On a CUDA tensor ``quantized_dot`` / ``quantized_dot_stacked`` launch the
hand-written kernels of ``csrc/quantized_matmul.cu`` (one per Pallas
kernel: ``qdot``, ``qdot_stacked``, ``q4dot``, ``q4dot_stacked``); the
stacked ones read layer ``li`` of an (L, D, Npad) stack in place. Each
launch follows ``launch_plan``: the body (``strip`` at M <= 16, ``wgmma``
above), its column tile, the split of the depth over blocks, the grid and
the workspace of partial sums. On a CPU tensor they take the plain
versions. No gradient: serving only.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

LANE = 128
LAUNCHES = {"qdot": 0, "qdot_stacked": 0, "q4dot": 0, "q4dot_stacked": 0}


class _Weight(nn.Module):
    """Payload and scale as buffers. The scale stays fp32 when the model
    around it is cast to another dtype."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self.scale = self.scale.float()
        return self


class QuantizedWeight(_Weight):
    """q int8 (..., D, Npad), scale fp32 (..., 1, Npad); ``n_out`` is the
    true output width. A layer-stacked weight has a leading L axis on
    both."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, n_out: int):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.n_out = int(n_out)

    @property
    def payload(self) -> torch.Tensor:
        return self.q

    def extra_repr(self) -> str:
        return f"q={tuple(self.q.shape)}, n_out={self.n_out}"


class Int4Weight(_Weight):
    """p int8 (..., D/2, Npad) packed nibbles, scale fp32 (..., G, Npad)
    with G = D / group_size; same stacking contract as
    ``QuantizedWeight``."""

    def __init__(self, p: torch.Tensor, scale: torch.Tensor, n_out: int,
                 group_size: int):
        super().__init__()
        self.register_buffer("p", p)
        self.register_buffer("scale", scale)
        self.n_out = int(n_out)
        self.group_size = int(group_size)

    @property
    def payload(self) -> torch.Tensor:
        return self.p

    def extra_repr(self) -> str:
        return (f"p={tuple(self.p.shape)}, n_out={self.n_out}, "
                f"g={self.group_size}")


def int4_group_size(D: int, group_size: int = 128) -> int:
    """``group_size`` shrunk to ``gcd(group_size, D/2)`` when it does not
    divide the half depth (small models); 2048 and 8192 keep 128."""
    if D % 2:
        raise ValueError(f"int4 packing needs an even contracted dim, got "
                         f"D={D}")
    return math.gcd(int(group_size), D // 2)


def empty_weight(bits: int, shape, group_size: int = 128, device=None):
    """An uninitialized quantized weight for a (..., D, N) matrix."""
    *lead, D, n = shape
    npad = n + (-n) % LANE
    if bits == 8:
        return QuantizedWeight(
            torch.empty((*lead, D, npad), dtype=torch.int8, device=device),
            torch.empty((*lead, 1, npad), dtype=torch.float32, device=device),
            n)
    if bits == 4:
        gs = int4_group_size(D, group_size)
        return Int4Weight(
            torch.empty((*lead, D // 2, npad), dtype=torch.int8,
                        device=device),
            torch.empty((*lead, D // gs, npad), dtype=torch.float32,
                        device=device), n, gs)
    raise ValueError(f"bits={bits} (supported: 8, 4)")


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """amax / qmax (1 where amax is 0) as an IEEE division, which is what
    the JAX package's eager quantize computes: the divisor is a tensor,
    because PyTorch turns a division by a Python scalar on CUDA into a
    multiplication by its reciprocal, an ulp away."""
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones_like(amax))


def _pad_last(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    return t if not pad else torch.nn.functional.pad(t, (0, pad), value=value)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, pad_to: int = LANE) -> QuantizedWeight:
    """Per-output-channel symmetric int8 over the contracted (-2) axis of a
    (..., D, N) matrix: scale amax/127, codes rounded half to even and
    clipped to +-127."""
    n = w.shape[-1]
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = _scale(amax, 127.0)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    pad = (-n) % pad_to
    return QuantizedWeight(_pad_last(q, pad, 0), _pad_last(scale, pad, 1.0),
                           n)


@torch.no_grad()
def quantize_weight_int4(w: torch.Tensor, group_size: int = 128,
                         pad_to: int = LANE) -> Int4Weight:
    """Symmetric int4 over groups of ``int4_group_size(D, group_size)`` rows
    of the contracted (-2) axis: scale amax/7, codes clipped to +-7, rows
    ``d`` and ``d + D/2`` packed into one byte."""
    D, n = w.shape[-2], w.shape[-1]
    gs = int4_group_size(D, group_size)
    lead = w.shape[:-2]
    wf = w.float().reshape(*lead, D // gs, gs, n)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = _scale(amax, 7.0)
    q = torch.round(wf / scale).clamp_(-7, 7).to(torch.int32)
    q = q.reshape(*lead, D, n)
    scale = scale.reshape(*lead, D // gs, n)
    lo, hi = q[..., : D // 2, :], q[..., D // 2:, :]
    packed = ((lo & 0xF) | (hi << 4)).to(torch.int8)
    pad = (-n) % pad_to
    return Int4Weight(_pad_last(packed, pad, 0), _pad_last(scale, pad, 1.0),
                      n, gs)


def unpack_nibbles(b: torch.Tensor):
    """Packed int8 (..., D/2, N) -> (lo, hi) int32 in [-7, 7]: the low
    nibble sign-extended, the high one by an arithmetic shift."""
    b32 = b.to(torch.int32)
    return ((b32 & 0xF) ^ 8) - 8, b32 >> 4


QUANT_WEIGHT_NAMES = ("wqkv", "wo", "w1", "w3", "w2")


@torch.no_grad()
def quantize_llm_params(llm, bits: int = 8, group_size: int = 128):
    """An ``InternLM2Model`` with its matmul weights in int8 or int4: a
    ``QuantizedInternLM2`` that holds each of the five per-layer weights as
    one layer-stacked (L, D, Npad) quantized weight and the quantized vocab
    head, and shares the embedding, norms and biases with ``llm``. A model
    that is quantized already comes back as it is."""
    from v2pe_tpu_torch.models.internlm2 import (InternLM2Model,
                                                 QuantizedInternLM2)

    if bits not in (8, 4):
        raise ValueError(f"bits={bits} (supported: 8, 4)")
    if isinstance(llm, QuantizedInternLM2):
        return llm
    if not isinstance(llm, InternLM2Model):
        raise TypeError(f"expected an InternLM2Model, got {type(llm)}")
    quant = quantize_weight if bits == 8 else \
        (lambda w: quantize_weight_int4(w, group_size))

    def stacked(ws):
        """Each layer's (N, D) linear weight quantized as its (D, N)
        kernel, one layer at a time, then stacked."""
        parts = [quant(w.t()) for w in ws]
        first = parts[0]
        extra = () if bits == 8 else (first.group_size,)
        return type(first)(torch.stack([p.payload for p in parts]),
                           torch.stack([p.scale for p in parts]),
                           first.n_out, *extra)

    stacks = {name: stacked([getattr(layer, name).weight
                             for layer in llm.layers])
              for name in QUANT_WEIGHT_NAMES}
    return QuantizedInternLM2.from_parts(llm, stacks,
                                         quant(llm.output.weight.t()))


class StackedQuantizedRef:
    """Layer ``li`` of a layer-stacked quantized weight, for the layer loop:
    the stack stays whole and the product reads the layer in place."""

    __slots__ = ("qw", "li")

    def __init__(self, qw: _Weight, li: int):
        if qw.payload.ndim != 3:
            raise ValueError("expects a layer-stacked (L, D, N) weight")
        self.qw = qw
        self.li = int(li)


# --------------------------------------------------------- plain versions


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dequant_int4_half(q: torch.Tensor, s: torch.Tensor, gs: int):
    """(D2, N) int32 nibbles, (G2, N) fp32 scales -> (D2, N) bf16 values as
    fp32."""
    D2, n = q.shape
    deq = q.float().reshape(D2 // gs, gs, n) * s[:, None, :]
    return _bf16(deq.reshape(D2, n))


def _plain(x: torch.Tensor, w: _Weight, payload: torch.Tensor,
           scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """The product on one layer's ``payload`` / ``scale`` of ``w``."""
    lead, D = x.shape[:-1], x.shape[-1]
    xb = _bf16(x.reshape(-1, D))
    if isinstance(w, Int4Weight):
        lo, hi = unpack_nibbles(payload)
        D2, G2 = payload.shape[0], scale.shape[0] // 2
        out = xb[:, :D2] @ _dequant_int4_half(lo, scale[:G2], w.group_size) \
            + xb[:, D2:] @ _dequant_int4_half(hi, scale[G2:], w.group_size)
    else:
        out = (xb @ payload.float()) * scale
    return out[:, :w.n_out].reshape(*lead, w.n_out).to(out_dtype or x.dtype)


def quantized_dot_torch(x: torch.Tensor, w: _Weight,
                        out_dtype=None) -> torch.Tensor:
    """Plain version of ``quantized_dot``: a 2-D quantized weight."""
    _check(x, w, 2)
    return _plain(x, w, w.payload, w.scale, out_dtype)


def quantized_dot_stacked_torch(x: torch.Tensor, w: _Weight, li: int,
                                out_dtype=None) -> torch.Tensor:
    """Plain version of ``quantized_dot_stacked``: layer ``li`` of a
    stack."""
    _check(x, w, 3, li)
    return _plain(x, w, w.payload[li], w.scale[li], out_dtype)


# ------------------------------------------------------------ launch plan

SMS = 132                # streaming multiprocessors of an H100
STRIP_MAX_M = 16         # rows of x the strip body takes
STRIP_THREADS = 256
STRIP_ROWS = {False: 2048, True: 1024}  # code rows a split stages x for
TC_TILE = 128            # the wgmma body's (rows of x, columns) tile
TC_THREADS = 288


class Plan(NamedTuple):
    """One launch of a quantized product (``launch_plan``)."""
    body: int         # 0: strip (M <= 16), 1: wgmma
    mt: int           # strip: rows of x padded to 8 or 16 (wgmma: 0)
    bn: int           # output columns a block
    splits: int       # blocks that share a column tile's depth
    split_rows: int   # code rows (int4: byte rows) of a split
    grid: tuple       # blocks: strip (tiles, splits), wgmma (M tiles,
                      # column tiles)
    threads: int
    ws_bytes: int     # fp32 partial sums (splits, M, Npad); 0 if no split


@functools.lru_cache(maxsize=4096)
def launch_plan(M: int, D: int, Npad: int, gs: int, int4: bool) -> Plan:
    """The launch of one product of x (M, D) with codes (D or D/2, Npad).

    M > 16: the wgmma body, a 128 x 128 output tile a block over the whole
    depth, grid (M tiles, column tiles). M <= 16: the strip body. Its
    column tile bn is the widest of 128, 64, 32 with which the product
    launches at least two blocks a SM; the depth (K = D code rows, int4 D/2 byte rows) is cut into
    ``splits`` runs of ``split_rows`` rows, a multiple of 16 (int4: of the
    group size gs), the last one shorter, so that every row lies in exactly
    one split; a split stages at most 2048 rows of x. A split's partial sums
    go to a (splits, M, Npad) fp32 workspace. Raises ValueError on a form
    the kernels do not take."""
    M, D, Npad, gs, int4 = int(M), int(D), int(Npad), int(gs), bool(int4)
    if M <= 0 or D <= 0 or Npad <= 0 or Npad % 128:
        raise ValueError(f"no quantized-product launch for M={M}, D={D}, "
                         f"Npad={Npad} (Npad a positive multiple of 128)")
    if int4 and (D % 2 or gs <= 0 or (D // 2) % gs):
        raise ValueError(f"int4 needs an even depth and a group size that "
                         f"divides D/2: D={D}, gs={gs}")
    K = D // 2 if int4 else D
    if M > STRIP_MAX_M:
        return Plan(1, 0, TC_TILE, 1, K, (-(-M // TC_TILE), Npad // TC_TILE),
                    TC_THREADS, 0)
    mt = 8 if M <= 8 else 16
    gran = gs if int4 else 16
    rmax = STRIP_ROWS[int4]
    for bn in (128, 64, 32):
        tiles = Npad // bn
        want = max(-(-2 * SMS // tiles), -(-K // rmax))
        rows = max(gran, K // want // gran * gran)
        rows = min(rows, rmax)
        splits = -(-K // rows)
        if tiles * splits >= 2 * SMS:
            break
    if splits == 1:
        rows = K
    return Plan(0, mt, bn, splits, rows, (tiles, splits), STRIP_THREADS,
                4 * splits * M * Npad if splits > 1 else 0)


# ---------------------------------------------------------------- kernels


def _check(x: torch.Tensor, w: _Weight, ndim: int,
           li: Optional[int] = None) -> None:
    if not isinstance(w, (QuantizedWeight, Int4Weight)):
        raise TypeError(f"expected a quantized weight, got {type(w)}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the quantized products have no gradient: they "
                           "serve, they do not train")
    payload = w.payload
    if payload.ndim != ndim:
        raise ValueError(f"expected a {ndim}-D payload, got "
                         f"{tuple(payload.shape)}")
    rows = payload.shape[-2] * (2 if isinstance(w, Int4Weight) else 1)
    if x.shape[-1] != rows:
        raise ValueError(f"x has depth {x.shape[-1]}, the weight {rows}")
    if payload.device != x.device or w.scale.device != x.device:
        raise ValueError(f"x on {x.device}, the weight on {payload.device}")
    if li is not None and not 0 <= int(li) < payload.shape[0]:
        raise ValueError(f"layer {li} outside the stack's "
                         f"{payload.shape[0]} layers")


_COUNTERS = {}  # device index -> zeroed int32 counters, one a column tile


def _counters(device, tiles: int) -> torch.Tensor:
    """The device's split counters: zero between launches (the last block
    of a column tile resets its own), at least ``tiles`` of them."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


def _launch(x: torch.Tensor, w: _Weight, li: Optional[int], out_dtype):
    """Launch the kernel of (int8 | int4) x (2-D | layer of a stack) as
    ``launch_plan`` lays it out."""
    from v2pe_tpu_torch.ops import _build

    int4 = isinstance(w, Int4Weight)
    name = ("q4dot" if int4 else "qdot") + ("" if li is None else "_stacked")
    if not x.is_cuda:
        raise ValueError(f"no {name} kernel for device {x.device}")
    payload, scale = w.payload, w.scale
    if payload.dtype != torch.int8 or scale.dtype != torch.float32 \
            or not payload.is_contiguous() or not scale.is_contiguous():
        raise ValueError(f"{name}: payload must be contiguous int8 and the "
                         f"scale contiguous float32")
    out_dtype = out_dtype or x.dtype
    lead, D = x.shape[:-1], x.shape[-1]
    x2 = x if x.dim() == 2 else x.reshape(-1, D)
    if x2.dtype not in (torch.bfloat16, torch.float32):
        x2 = x2.float()
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    M, npad = x2.shape[0], payload.shape[-1]
    kernel_dtype = out_dtype if out_dtype in (torch.bfloat16,
                                              torch.float32) else torch.float32
    # (M, n_out) rows, shaped as x's leading dims
    out = torch.empty((*lead, w.n_out), dtype=kernel_dtype, device=x.device)
    if M == 0:
        return out.to(out_dtype)
    gs = w.group_size if int4 else 0
    plan = launch_plan(M, D, npad, gs, int4)
    if plan.body == 1 and x2.dtype == torch.float32:
        x2 = x2.to(torch.bfloat16)  # the kernel's rounding, once, for TMA
    ws = counters = None
    if plan.splits > 1:
        ws = torch.empty(plan.ws_bytes // 4, dtype=torch.float32,
                         device=x.device)
        counters = _counters(x.device, plan.grid[0])
    args = [x2.data_ptr(), payload.data_ptr(), scale.data_ptr(),
            out.data_ptr(), ws if ws is None else ws.data_ptr(),
            counters if counters is None else counters.data_ptr()]
    if li is not None:
        args += [int(li), payload.shape[0]]
    args += [M, D, npad, w.n_out]
    if int4:
        args.append(gs)
    args += [int(x2.dtype == torch.bfloat16),
             int(kernel_dtype == torch.bfloat16),
             plan.body, plan.mt, plan.bn, plan.splits, plan.split_rows,
             _build.raw_stream(x.device.index)]
    err = getattr(_build.load(), "v2pe_" + name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out if kernel_dtype == out_dtype else out.to(out_dtype)


def quantized_dot(x: torch.Tensor, w: _Weight, out_dtype=None):
    """``dot(x, dequant(w))`` for a 2-D quantized weight (the vocab head),
    fp32 accumulation, cast to ``out_dtype`` (default ``x.dtype``). The
    dequantized weight never exists in device memory."""
    if x.device.type == "cpu":
        return quantized_dot_torch(x, w, out_dtype)
    _check(x, w, 2)
    return _launch(x, w, None, out_dtype)


def quantized_dot_stacked(x: torch.Tensor, w: _Weight, li: int,
                          out_dtype=None):
    """``quantized_dot`` on layer ``li`` of a layer-stacked weight, read in
    place: no per-layer slice is copied."""
    if x.device.type == "cpu":
        return quantized_dot_stacked_torch(x, w, li, out_dtype)
    _check(x, w, 3, li)
    return _launch(x, w, li, out_dtype)
