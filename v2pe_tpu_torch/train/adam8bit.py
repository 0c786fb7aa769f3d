"""Block-wise 8-bit Adam moments (port of ``v2pe_tpu/train/adam8bit.py``).

The first and second moments are stored as int8 with one float32 scale per
block of ``BLOCK`` values: ``m`` on a symmetric linear code (scale =
absmax / 127), ``v`` on a sqrt code (code = round(127 * sqrt(v / absmax)),
scale = absmax / 127^2, dequantized by squaring). Each step dequantizes,
runs plain Adam in fp32 and requantizes, in chunks of about ``CHUNK_ELEMS``
values so that the fp32 temporaries stay small. Plain tensor code: the JAX
version has no Pallas kernel either.

The blocks run over a leaf of the JAX tree flattened in its own layout (a
stacked (L, ...) leaf; a linear's (in, out) kernel). The optimizer
(``train/optimizer.py``) hands each update a flat vector in that layout, so
codes and scales match the JAX state element for element.

The offloaded optimizer (``offload_optimizer``, DeepSpeed's ZeRO-Offload of
these moments; ``v2pe_tpu/train/adam8bit.py:93-215``) keeps the state in
pinned host memory and runs each segment's update on the card through a
:class:`Stager`: the update itself is :func:`update`, so the codes and
scales are the resident ones bit for bit.
"""

from __future__ import annotations

import torch

BLOCK = 256
CHUNK_ELEMS = 4 * 2 ** 20
# the scales multiply by these fp32 reciprocals, as XLA compiles the JAX
# version's divisions by the constants 127 and 127^2 (so codes and scales
# come out equal to the bit)
INV_127 = float(torch.tensor(1 / 127.0, dtype=torch.float32))
INV_127_SQ = float(torch.tensor(1 / 127.0 ** 2, dtype=torch.float32))


def zeros(numel: int, device=None, pin: bool = False) -> dict:
    """The state of a leaf of ``numel`` values: every moment 0. ``pin``:
    in page-locked host memory (``device`` the CPU), which a copy to or
    from the card reads and writes without blocking the host."""
    nb = -(-numel // BLOCK)
    kw = dict(device=device, pin_memory=pin)
    return {"m_code": torch.zeros(numel, dtype=torch.int8, **kw),
            "m_scale": torch.zeros(nb, dtype=torch.float32, **kw),
            "v_code": torch.zeros(numel, dtype=torch.int8, **kw),
            "v_scale": torch.zeros(nb, dtype=torch.float32, **kw)}


def segment(state: dict, offset: int, numel: int) -> dict:
    """Views of the codes and scales of values [offset, offset + numel)
    of a leaf's state (``offset`` a multiple of BLOCK): an update of the
    views with offset 0 is the update of the state at ``offset``."""
    if offset % BLOCK:
        raise ValueError(f"offset {offset} is not a multiple of {BLOCK}")
    s0, s1 = offset // BLOCK, -(-(offset + numel) // BLOCK)
    return {"m_code": state["m_code"][offset:offset + numel],
            "m_scale": state["m_scale"][s0:s1],
            "v_code": state["v_code"][offset:offset + numel],
            "v_scale": state["v_scale"][s0:s1]}


def _blocks(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x zero-padded to rows * BLOCK values, as (rows, BLOCK)."""
    pad = rows * BLOCK - x.numel()
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    return x.reshape(rows, BLOCK)


@torch.no_grad()
def update(g: torch.Tensor, state: dict, offset: int, *, b1: float,
           b2: float, eps: float, bc1: torch.Tensor,
           bc2: torch.Tensor) -> torch.Tensor:
    """One Adam step of the flat fp32 gradient ``g``, which covers values
    [offset, offset + g.numel()) of the leaf (``offset`` a multiple of
    BLOCK). The codes and scales of those values are updated in place; the
    fp32 update m̂ / (sqrt(v̂) + eps) is returned. bc1/bc2 are the bias
    corrections 1 - b^count as float32 scalars."""
    if offset % BLOCK:
        raise ValueError(f"offset {offset} is not a multiple of {BLOCK}")
    n = g.numel()
    out = torch.empty_like(g)
    nb = -(-n // BLOCK)
    rows = min(nb, max(1, CHUNK_ELEMS // BLOCK))
    for r0 in range(0, nb, rows):
        r1 = min(r0 + rows, nb)
        e0, e1 = r0 * BLOCK, min(r1 * BLOCK, n)
        s0, s1 = offset // BLOCK + r0, offset // BLOCK + r1
        ce = slice(offset + e0, offset + e1)
        gf = _blocks(g[e0:e1], r1 - r0)
        m = _blocks(state["m_code"][ce], r1 - r0).float() \
            * state["m_scale"][s0:s1, None]
        v = _blocks(state["v_code"][ce], r1 - r0).float() ** 2 \
            * state["v_scale"][s0:s1, None]
        m = b1 * m + (1 - b1) * gf
        v = b2 * v + (1 - b2) * gf * gf
        out[e0:e1] = ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                      ).reshape(-1)[:e1 - e0]
        msc = m.abs().amax(dim=1) * INV_127
        msafe = torch.where(msc > 0, msc, 1.0)
        mcode = torch.clamp(torch.round(m / msafe[:, None]), -127, 127)
        vmax = v.amax(dim=1)
        vsafe = torch.where(vmax > 0, vmax, 1.0)
        vcode = torch.clamp(torch.round(127.0 * torch.sqrt(v / vsafe[:, None])),
                            0, 127)
        state["m_code"][ce] = mcode.to(torch.int8).reshape(-1)[:e1 - e0]
        state["v_code"][ce] = vcode.to(torch.int8).reshape(-1)[:e1 - e0]
        state["m_scale"][s0:s1] = msc
        state["v_scale"][s0:s1] = vmax * INV_127_SQ
    return out


class Stager:
    """Runs segments' updates on ``device`` over state kept in host memory.

    :meth:`run` takes the host segments (dicts of :func:`segment` views) in
    the order of their updates. Each is copied host to device on an upload
    stream into one of two device buffers, sized once a run for the largest
    segment; the update runs on the current stream on that buffer; the
    result is copied back into the segment's own host views with
    ``non_blocking`` on a download stream. Segment i + 1 is uploaded while
    segment i updates; a buffer is uploaded into only after an event says
    its last copy back has finished, so the staging holds two segments,
    never the state. ``run`` returns once the last copy back has landed
    (the host waits for it): a later reader of the host state, the next
    step's upload or a checkpoint's snapshot, sees the whole update.

    On a CPU ``device`` the same copies run host to host, in order (no
    streams): the state is still staged, not updated in place.
    ``moved`` counts the bytes copied each way in the last run; on the
    card :meth:`copy_ms` gives the time of its copies (upload, download)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.moved = 0
        self._spans = ([], [])  # (start, end) events of uploads, downloads

    def run(self, segments: list, fn) -> None:
        """``fn(i, state)`` updates segment i in ``state`` (device views of
        the same shapes); its host views are written back after it."""
        if not segments:
            return
        size = {k: max(s[k].numel() for s in segments) for k in segments[0]}
        bufs = [{k: torch.empty(n, dtype=segments[0][k].dtype,
                                device=self.device) for k, n in size.items()}
                for _ in range(2)]
        self.moved = sum(t.numel() * t.element_size()
                         for s in segments for t in s.values())
        self._spans = ([], [])
        if not self.cuda:
            for i, seg in enumerate(segments):
                dev = self._views(bufs[i % 2], seg)
                for k, t in seg.items():
                    dev[k].copy_(t)
                fn(i, dev)
                for k, t in seg.items():
                    t.copy_(dev[k])
            return
        compute = torch.cuda.current_stream(self.device)
        up = torch.cuda.Stream(self.device)
        down = torch.cuda.Stream(self.device)
        # the buffers were allocated on the compute stream: the copy
        # streams start behind it
        up.wait_stream(compute)
        down.wait_stream(compute)
        ready, freed = [None, None], [None, None]

        def fetch(i):
            b = i % 2
            with torch.cuda.stream(up):
                if freed[b] is not None:
                    up.wait_event(freed[b])
                dev = self._views(bufs[b], segments[i])
                start = self._mark(up)
                for k, t in segments[i].items():
                    dev[k].copy_(t, non_blocking=True)
                ready[b] = self._mark(up)
                self._spans[0].append((start, ready[b]))
            return dev

        staged = fetch(0)
        for i, seg in enumerate(segments):
            dev, b = staged, i % 2
            if i + 1 < len(segments):
                staged = fetch(i + 1)
            compute.wait_event(ready[b])
            fn(i, dev)
            done = self._mark(compute)
            with torch.cuda.stream(down):
                down.wait_event(done)
                start = self._mark(down)
                for k, t in seg.items():
                    t.copy_(dev[k], non_blocking=True)
                freed[b] = self._mark(down)
                self._spans[1].append((start, freed[b]))
        down.synchronize()  # the host state is whole before run returns

    @staticmethod
    def _views(buf: dict, seg: dict) -> dict:
        return {k: buf[k][:t.numel()] for k, t in seg.items()}

    @staticmethod
    def _mark(stream) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def copy_ms(self) -> tuple:
        """Milliseconds of the last run's uploads and downloads, each
        summed over its segments (on the card; None on the CPU)."""
        if not self.cuda:
            return None
        return tuple(sum(a.elapsed_time(b) for a, b in spans)
                     for spans in self._spans)
