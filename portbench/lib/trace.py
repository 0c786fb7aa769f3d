"""The device trace of a traced run, and the host spans beside it.

The profiler records the card's kernels, copies and sets (CUPTI, through
PyTorch's Kineto profiler, no CPU operators) over whole scheduler steps:
it is switched on at the start of the first step after one host time and
off at the end of the first step after another, so the work of the steps
in between is the work the trace holds. Busy time is the union of the
device's activity; an idle gap is named by the host span it fell in.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


def _kineto():
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)

    return (ProfilerConfig, ProfilerState, _prepare_profiler,
            _enable_profiler, _disable_profiler, ProfilerActivity,
            _ExperimentalConfig)


class DeviceTrace:
    """Start and stop Kineto on the card without building Python events
    for every operation; ``events()`` gives (name, start_ns, end_ns) of
    the device's activity."""

    def __init__(self, device: str = "cuda"):
        (Config, State, prepare, self._enable, self._disable, Act,
         Exp) = _kineto()
        act = Act.CUDA if device == "cuda" else Act.CPU
        self._acts = {act}
        flags = (State.KINETO, False, False, False, False, False, Exp())
        try:
            self._config = Config(*flags)
        except TypeError:  # later versions add a trace id
            self._config = Config(*flags, "")
        prepare(self._config, self._acts)
        self.device = device
        self.result = None
        self.host_start_ns = self.host_end_ns = 0
        self.wall_s = 0.0

    def start(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()
        self._enable(self._config, self._acts)
        self.host_start_ns = time.time_ns()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.host_end_ns = time.time_ns()
        self.result = self._disable()

    def events(self) -> List[Tuple[str, int, int]]:
        want = "CUDA" if self.device == "cuda" else "CPU"
        out = []
        for e in self.result.events():
            if str(e.device_type()).endswith(want):
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out


def warm(device: str = "cuda") -> None:
    """One short trace, so that the profiler's first start (which loads
    CUPTI) falls into set-up."""
    t = DeviceTrace(device)
    t.start()
    torch.zeros(1, device=device).add_(1)
    t.stop()
    t.events()


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(trace: DeviceTrace, spans: List[Tuple[str, int, int]]
              ) -> Dict[str, object]:
    """Busy seconds, kernel seconds and counts by name, and idle seconds
    by the host span each gap fell in (``spans``: (label, start_ns,
    end_ns) on ``time.time_ns``'s clock)."""
    ev = trace.events()
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for name, s, e in ev:
        by_name[name] += (e - s) * 1e-9
        count[name] += 1
    busy = union([(s, e) for _, s, e in ev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # the trace's clock against the host's: Kineto stamps its events on
    # the host's clock; a trace whose events lie outside the host window
    # by more than a second is on another clock, and its gaps go unnamed
    same_clock = not ev or abs(min(s for _, s, _ in ev)
                               - trace.host_start_ns) < 1_000_000_000
    gaps: Dict[str, float] = defaultdict(float)
    edges = [trace.host_start_ns] + [x for iv in busy for x in iv] + \
        [trace.host_end_ns]
    # the spans come from the one scheduler thread, so none overlaps
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s for _, s, _ in spans]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = "unnamed"
        if same_clock:
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = spans[i][0] if i >= 0 and mid <= spans[i][2] \
                else "scheduler"
        gaps[label] += (b - a) * 1e-9
    return {"busy_s": busy_s, "window_s": trace.wall_s,
            "kernel_s": dict(by_name), "kernel_n": dict(count),
            "idle_s": dict(gaps), "events": len(ev)}


def kernel_seconds(summary: dict, *parts: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose names hold any of
    ``parts``."""
    s = n = 0
    for name, t in summary["kernel_s"].items():
        if any(p in name for p in parts):
            s += t
            n += summary["kernel_n"][name]
    return s, n


def breakdown(summary: dict, top: int = 10) -> Dict[str, list]:
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:96], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
