"""Parallelism of the port (``v2pe_tpu/parallel/``): the ring and Ulysses
attention over the ``seq`` axis, on one card or across processes, and the
bootstrap and placement of a training mesh over ``torch.distributed``."""
