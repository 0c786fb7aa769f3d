"""v2pe_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of v2pe_tpu.

The JAX package ``v2pe_tpu`` stays the reference. This package keeps its
module names and public function names (``ops/``, ``models/``, ``infer/``),
so each counterpart is found at the same path, and runs on ``torch`` alone:
it never imports ``jax``.

Host-side code that has no JAX in it (configs, V2PE position ids, chat
templates, tiling, image transforms, sample packing) is imported from
``v2pe_tpu`` rather than copied; it is re-exported here.

The TPU kernels on the serving and training paths (the Pallas flash
forward and backward, the paged-attention kernels) are hand-written CUDA
kernels for ``sm_90a`` in ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``) and wrapped by ``ops/flash_fwd.py``,
``ops/flash_bwd.py`` and ``ops/paged_attention.py``.
"""

from v2pe_tpu import positional
from v2pe_tpu.core import config
from v2pe_tpu.data import constants, conversation, packing, tiling, transforms

__all__ = ["config", "constants", "conversation", "packing", "positional",
           "tiling", "transforms"]
