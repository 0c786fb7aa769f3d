"""Dataset validator.

Analogue of the reference's closest thing to a test harness:
``internvl2_5/train/test_data.py`` (253 LoC) — iterate every sample of every
dataset through the real pipeline and assert the ``<img>...</img>``
token-count invariant, logging structured error records to JSON. No fake
distributed backend needed here (the pipeline is already host-pure)."""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def validate_sample(sample: dict, *, num_image_token: int,
                    img_start_id: int, img_end_id: int,
                    img_context_id: int) -> List[str]:
    """Returns a list of violation strings (empty = OK). Invariants match
    test_data.py:211-221 plus pos-id structural checks."""
    errs = []
    ids = np.asarray(sample["input_ids"])
    starts = np.where(ids == img_start_id)[0]
    ends = np.where(ids == img_end_id)[0]
    n_ctx = int((ids == img_context_id).sum())
    num_tiles = sample.get("num_tiles", [])
    flags = np.asarray(sample.get("image_flags", []))

    if len(starts) != len(ends):
        errs.append(f"unbalanced <img>/</img>: {len(starts)} vs {len(ends)}")
    if flags.sum() > 0:
        expected_ctx = num_image_token * int(sum(num_tiles))
        if n_ctx != expected_ctx:
            errs.append(
                f"IMG_CONTEXT count {n_ctx} != num_image_token*tiles "
                f"{expected_ctx}")
        if len(starts) != len(num_tiles):
            errs.append(f"{len(starts)} images but {len(num_tiles)} "
                        "num_tiles entries")
    pos = np.asarray(sample.get("pos_ids", []))
    if pos.size:
        if pos.shape != ids.shape:
            errs.append("pos_ids shape mismatch")
        elif not np.isfinite(pos).all():
            errs.append("non-finite pos_ids")
    labels = np.asarray(sample.get("labels", []))
    if labels.size and (labels != -100).sum() == 0:
        errs.append("fully masked sample (tokenization mismatch?)")
    return errs


def validate_datasets(datasets: Dict[str, object], *, num_image_token: int,
                      img_start_id: int, img_end_id: int,
                      img_context_id: int,
                      max_samples_per_ds: Optional[int] = None,
                      error_log_path: Optional[str] = None) -> dict:
    """Iterate all datasets, collect violations; returns summary dict."""
    records = []
    counts = {}
    for name, ds in datasets.items():
        n = len(ds) if max_samples_per_ds is None \
            else min(len(ds), max_samples_per_ds)
        ok = 0
        for i in range(n):
            try:
                s = ds.get(i)
            except Exception as e:
                records.append({"dataset": name, "index": i,
                                "error": f"load failure: {e}"})
                continue
            errs = validate_sample(
                s, num_image_token=num_image_token,
                img_start_id=img_start_id, img_end_id=img_end_id,
                img_context_id=img_context_id)
            if errs:
                records.append({"dataset": name, "index": i, "error": errs})
            else:
                ok += 1
        counts[name] = {"checked": n, "ok": ok,
                        "bad": n - ok}
        logger.info("%s: %d/%d samples valid", name, ok, n)
    if error_log_path and records:
        with open(error_log_path, "w") as f:
            json.dump(records, f, indent=2, default=str)
    return {"counts": counts, "num_errors": len(records),
            "errors": records[:50]}
