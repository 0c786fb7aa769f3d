"""Run a JAX function and its PyTorch port on the same numpy inputs and
report how far their outputs are apart.

Both callables receive the inputs converted to their own framework
(``jnp.asarray`` / ``torch.from_numpy``) and may return an array or a
tuple/list of arrays; outputs are compared pairwise in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _flat(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


@dataclasses.dataclass
class Parity:
    jax: List[np.ndarray]
    torch: List[np.ndarray]
    max_abs: float  # largest |jax - torch| over every output
    max_rel: float  # largest |jax - torch| / max(|jax|, tiny)

    def assert_close(self, atol: float, rtol: float,
                     masks: Optional[Sequence] = None) -> None:
        for i, (a, b) in enumerate(zip(self.jax, self.torch)):
            m = None if masks is None else masks[i]
            if m is not None:
                a, b = a[m], b[m]
            np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                       err_msg=f"output {i}")


def run_parity(jax_fn: Callable, torch_fn: Callable, *inputs) -> Parity:
    """Call both with the same numpy inputs; compare every output."""
    jout = _flat(jax_fn(*[jnp.asarray(x) for x in inputs]))
    tout = _flat(torch_fn(*[torch.from_numpy(np.array(x)) for x in inputs]))
    assert len(jout) == len(tout), (len(jout), len(tout))
    ja = [to_numpy(x).astype(np.float64) for x in jout]
    ta = [to_numpy(x).astype(np.float64) for x in tout]
    max_abs = max_rel = 0.0
    for a, b in zip(ja, ta):
        assert a.shape == b.shape, (a.shape, b.shape)
        d = np.abs(a - b)
        if d.size:
            max_abs = max(max_abs, float(d.max()))
            max_rel = max(max_rel, float((d / np.maximum(np.abs(a),
                                                         1e-12)).max()))
    return Parity(ja, ta, max_abs, max_rel)
