from v2pe_tpu_torch.data import constants, tiling, transforms, conversation, preprocess

__all__ = ["constants", "tiling", "transforms", "conversation", "preprocess"]
