"""Tracing and step timing (port of ``v2pe_tpu/utils/profiling.py``):
``torch.profiler`` traces viewable in Perfetto / chrome://tracing, named
step ranges, and a rolling step timer for throughput accounting."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

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


class StepTimer:
    """Rolling throughput accounting (tokens/sec, step time percentiles)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._last = None

    def tick(self, tokens: int = 0) -> Optional[dict]:
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self.times.append((dt, tokens))
        if len(self.times) > self.window:
            self.times.pop(0)
        total_t = sum(t for t, _ in self.times)
        total_tok = sum(n for _, n in self.times)
        steps = sorted(t for t, _ in self.times)
        return {
            "step_time_p50": steps[len(steps) // 2],
            "step_time_last": dt,
            "tokens_per_sec": total_tok / total_t if total_t else 0.0,
        }
