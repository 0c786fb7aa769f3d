"""v2pe_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of v2pe_tpu.

The JAX package ``v2pe_tpu`` stays the reference. This package keeps its
module names and public function names (``ops/``, ``models/``, ``infer/``),
so each counterpart is found at the same path, and runs on ``torch`` alone:
it never imports ``jax``.

Host-side code (configs, V2PE position ids, chat templates, tiling, image
transforms, sample packing, datasets, the native image ops) is the port's
own copy, under the same relative names (``core/config.py``,
``positional/``, ``data/``, ``native/``, ``train/synth.py``): nothing here
imports ``v2pe_tpu``. The most used modules are re-exported below.

The TPU kernels on the serving, training and sequence-parallel paths (the
Pallas flash forward and backward, the paged-attention kernels, the
weight-only int8 / int4 matrix products, the fused ring forward) are
hand-written CUDA kernels for ``sm_90a`` in ``csrc/``, built with ``nvcc``
at first use (``ops/_build.py``) and wrapped by ``ops/flash_fwd.py``,
``ops/flash_bwd.py``, ``ops/paged_attention.py``,
``ops/quantized_matmul.py`` and ``parallel/ring_fused.py``.
"""

from v2pe_tpu_torch import positional
from v2pe_tpu_torch.core import config
from v2pe_tpu_torch.data import constants, conversation, packing, tiling, transforms

__all__ = ["config", "constants", "conversation", "packing", "positional",
           "tiling", "transforms"]
