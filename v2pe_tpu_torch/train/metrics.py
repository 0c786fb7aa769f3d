"""Training metrics sinks (port of ``v2pe_tpu/train/metrics.py``): a sink
is a ``metrics_hook(step, metrics)`` for ``train.trainer.train``.

* :class:`JsonlMetricsSink`: one JSON object per logged step (append mode);
* :class:`TensorBoardMetricsSink`: scalars through torch's SummaryWriter,
  imported when the sink is built;
* :func:`build_metrics_hook`: one callable over the requested sinks.

One process: there is no rank-0 gate.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Iterable, Optional


class JsonlMetricsSink:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def __call__(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardMetricsSink:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=log_dir)

    def __call__(self, step: int, metrics: dict) -> None:
        for k, v in metrics.items():
            self._w.add_scalar(f"train/{k}", float(v), step)
        self._w.flush()

    def close(self) -> None:
        self._w.close()


def build_metrics_hook(
    output_dir: str,
    report_to: Iterable[str] = ("jsonl",),
    extra_hook: Optional[Callable[[int, dict], None]] = None,
) -> Callable[[int, dict], None]:
    """Compose sinks. report_to: a subset of {'jsonl', 'tensorboard',
    'none'}; other names raise, and a missing tensorboard backend falls
    back to jsonl with a warning."""
    sinks = []
    for name in report_to:
        if name == "jsonl":
            sinks.append(JsonlMetricsSink(
                os.path.join(output_dir, "metrics.jsonl")))
        elif name == "tensorboard":
            try:
                sinks.append(TensorBoardMetricsSink(
                    os.path.join(output_dir, "tb")))
            except ImportError:
                logging.getLogger(__name__).warning(
                    "tensorboard unavailable; logging metrics to jsonl only")
                if not any(isinstance(s, JsonlMetricsSink) for s in sinks):
                    sinks.append(JsonlMetricsSink(
                        os.path.join(output_dir, "metrics.jsonl")))
        elif name != "none":
            raise ValueError(f"unknown metrics sink {name!r}")
    if extra_hook:
        sinks.append(extra_hook)

    def hook(step: int, metrics: dict) -> None:
        for s in sinks:
            s(step, metrics)

    return hook
