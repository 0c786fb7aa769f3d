"""Tracing (port of ``v2pe_tpu/utils/profiling.py``): ``torch.profiler``
traces viewable in Perfetto / chrome://tracing, named step ranges, and host
spans that add up into a program's counters (:class:`SpanRecorder`)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the host and, where a CUDA card is present, its kernels:
    ``with profile_trace('traces'): step()`` writes a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``logdir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def step_marker(name: str):
    """A named range on the profiler's timeline (``record_function``), and
    an NVTX range when a CUDA card is present."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class SpanRecorder:
    """Host spans that add up into counters, and a bounded log of them.

    ``span(name)`` adds its duration to the integer ``counters[name +
    "_ns"]``; the counters are a dict its owner keeps and exports (the
    serving engine passes its ``stats``). The clock is ``time.time_ns()``,
    the Unix epoch in ns: the clock Kineto stamps ``torch.profiler``'s host
    and device events on, so a span lies on a trace's own time line. With
    the log off, the default, a span costs two clock reads and a dict add.

    ``record(capacity)`` attaches the log: a ring of the last ``capacity``
    spans, each ``(name, start_ns, end_ns, parent, request_id)``.
    ``drain()`` returns and clears it. Spans nest on one thread; ``drain``
    may be called from another."""

    def __init__(self, counters: dict):
        self.counters = counters
        self._log: Optional[Deque[tuple]] = None
        self._open: List[int] = []  # sequence numbers of open logged spans
        self._seq = 0

    def record(self, capacity: int = 65536) -> None:
        """Attach a log of the last ``capacity`` spans."""
        self._log = deque(maxlen=capacity)

    def drain(self) -> List[Tuple[str, int, int, int, int]]:
        """The spans closed since the last drain, in the order they opened.
        ``parent`` is the index in this list of the enclosing span, or -1
        where there is none or it is not in the list (still open, or pushed
        out of the ring)."""
        got = []
        log = self._log
        while log:
            got.append(log.popleft())
        got.sort()
        index = {g[0]: i for i, g in enumerate(got)}
        return [(name, t0, t1, index.get(parent, -1), rid)
                for _, name, t0, t1, parent, rid in got]

    @contextlib.contextmanager
    def span(self, name: str, request_id: int = -1):
        """Time the body into ``counters[name + "_ns"]``; yields the start
        (ns)."""
        key = name + "_ns"
        log = self._log
        t0 = time.time_ns()
        if log is None:
            try:
                yield t0
            finally:
                self.counters[key] = self.counters.get(key, 0) + \
                    time.time_ns() - t0
            return
        seq = self._seq
        self._seq += 1
        parent = self._open[-1] if self._open else -1
        self._open.append(seq)
        try:
            yield t0
        finally:
            t1 = time.time_ns()
            self._open.pop()
            self.counters[key] = self.counters.get(key, 0) + t1 - t0
            log.append((seq, name, t0, t1, parent, request_id))
