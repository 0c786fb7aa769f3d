"""The card: whether it is there, what it is, and what it reads."""

from __future__ import annotations

import subprocess
import sys

import torch

BLOCKED = ("jax", "jaxlib", "flax", "v2pe_tpu")


def require_cards(n: int) -> None:
    """Exit with code 2, printing no result, unless ``n`` CUDA cards are
    there."""
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card (torch.cuda.is_available() is "
                 "false)")
    if torch.cuda.device_count() < n:
        sys.exit(f"portbench: the cell needs {n} cards, "
                 f"{torch.cuda.device_count()} are there")


def smi(fields: str = "name,power.limit,clocks.sm,clocks.mem,power.draw,"
        "temperature.gpu") -> str:
    """One ``nvidia-smi`` reading of the cards, or why there is none."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def info(count: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def jax_loaded(modules=None) -> list:
    """Top-level names of the loaded modules (or of ``modules``) that are
    JAX or the JAX package, compared whole (``v2pe_tpu_torch`` is not
    ``v2pe_tpu``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(BLOCKED))
