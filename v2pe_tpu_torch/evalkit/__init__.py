from v2pe_tpu_torch.evalkit import metrics, runner

__all__ = ["metrics", "runner"]
