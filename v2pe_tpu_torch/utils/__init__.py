"""Runtime diagnostics and profiling (port of ``v2pe_tpu/utils/``:
``diagnostics.py`` and ``profiling.py``; the JAX package's compile cache
and int4 compatibility shims have no counterpart here)."""
