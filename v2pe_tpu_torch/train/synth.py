"""The synthetic packed-batch builder of ``v2pe_tpu/train/synth.py``
(numpy only), loaded from its file: importing it as ``v2pe_tpu.train.synth``
would run ``v2pe_tpu/train/__init__.py``, which imports jax."""

from __future__ import annotations

import importlib.util
import os
import sys

import v2pe_tpu

_NAME = "v2pe_tpu_torch.train._jax_synth"
if _NAME not in sys.modules:
    _spec = importlib.util.spec_from_file_location(
        _NAME, os.path.join(os.path.dirname(v2pe_tpu.__file__), "train",
                            "synth.py"))
    sys.modules[_NAME] = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(sys.modules[_NAME])
_synth = sys.modules[_NAME]

IMG_START_ID = _synth.IMG_START_ID
IMG_END_ID = _synth.IMG_END_ID
IMG_CONTEXT_ID = _synth.IMG_CONTEXT_ID
make_synthetic_batch = _synth.make_synthetic_batch
zigzag_permutation = _synth.zigzag_permutation
