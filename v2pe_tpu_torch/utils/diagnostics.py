"""Runtime diagnostics (port of ``v2pe_tpu/utils/diagnostics.py``).

``nan_guard`` reports non-finite values of a tensor and passes it through;
``assert_finite`` is the hard check over a module, a state dict or nested
containers, for tests and eval. Neither package calls them on a hot path.
"""

from __future__ import annotations

import logging

import torch
from torch import nn

logger = logging.getLogger(__name__)


def nan_guard(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Return ``x``, logging an error when it holds a NaN or an inf. One
    ``torch.isfinite`` reduction, whose result is read back once: on a CUDA
    tensor that waits for the card (the JAX version's debug callback does
    not block the traced program)."""
    if not bool(torch.isfinite(x).all()):
        logger.error("NaN/Inf detected in %s", name)
    return x


def _leaves(tree, path: str):
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if torch.is_tensor(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):  # JAX's key path: [i]
            yield from _leaves(v, f"{path}/[{i}]" if path else f"[{i}]")


def assert_finite(tree, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` naming the first tensor of ``tree`` (a
    module, a state dict, or nested dicts / lists / tuples of tensors) that
    holds a NaN or an inf; its path joins the keys with '/' (a list's index
    as ``[i]``, as JAX's key paths print it). Reads every
    tensor back: test and eval use only."""
    for path, t in _leaves(tree, ""):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}:{path}")
