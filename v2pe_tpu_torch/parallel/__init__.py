"""Sequence parallelism of the port (``v2pe_tpu/parallel/``'s ring and
Ulysses attention), with every shard of the ``seq`` axis on one card."""
