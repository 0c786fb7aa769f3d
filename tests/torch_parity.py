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
import pytest
import torch

from v2pe_tpu_torch.core import config as port_config_lib


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the tests of a module that imports this
    fixture (the suite runs files side by side), the count restored after
    them: other files' tests keep the default, on which some of their
    exact token comparisons depend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_config(cfg):
    """The port's own config object with the fields of the JAX package's
    ``cfg`` (a VLMConfig, LLMConfig or VisionConfig; the port's classes are
    copies of the JAX package's), checked field for field."""
    fields = dataclasses.asdict(cfg)
    cls = getattr(port_config_lib, type(cfg).__name__)
    out = cls.from_dict(fields) if hasattr(cls, "from_dict") else cls(**fields)
    assert type(out) is not type(cfg)
    assert dataclasses.asdict(out) == fields
    return out


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


def port_paged_cache(jcache):
    """The port's ``PagedKVCache`` holding the state of a JAX one: a
    ``jnp.int4`` pool becomes the port's packed bytes (two dims of a token
    per byte), an int8 / fp32 / bf16 pool is carried as it is."""
    from v2pe_tpu_torch.infer import paged_kv as tpk
    from v2pe_tpu_torch.ops.paged_attention import pack_int4

    int4 = jcache.k_pages.dtype == jnp.int4

    def pages(x):
        if int4:
            return pack_int4(torch.from_numpy(
                np.array(x.astype(jnp.int8))))
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(
                np.array(x.astype(jnp.float32))).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    def plain(x):
        return None if x is None else torch.from_numpy(np.array(x))

    # a sequence-sharded pool crosses over whole (its next_page holds one
    # head a shard): one card holds every shard
    return tpk.PagedKVCache(
        k_pages=pages(jcache.k_pages), v_pages=pages(jcache.v_pages),
        page_table=plain(jcache.page_table), lengths=plain(jcache.lengths),
        next_page=plain(jcache.next_page), k_scales=plain(jcache.k_scales),
        v_scales=plain(jcache.v_scales), kv_bits=4 if int4 else 8)


def jax_paged_cache(tcache):
    """The JAX ``PagedKVCache`` holding the state of a port one (the
    inverse of :func:`port_paged_cache`: packed int4 bytes are unpacked into
    a ``jnp.int4`` pool)."""
    from v2pe_tpu.infer import paged_kv as jpk
    from v2pe_tpu_torch.ops.paged_attention import unpack_int4

    int4 = tcache.quantized and tcache.kv_bits == 4

    def pages(x):
        if int4:
            return jnp.asarray(unpack_int4(x).numpy()).astype(jnp.int4)
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())

    def plain(x):
        return None if x is None else jnp.asarray(x.numpy())

    return jpk.PagedKVCache(
        k_pages=pages(tcache.k_pages), v_pages=pages(tcache.v_pages),
        page_table=plain(tcache.page_table), lengths=plain(tcache.lengths),
        next_page=plain(tcache.next_page), k_scales=plain(tcache.k_scales),
        v_scales=plain(tcache.v_scales))
