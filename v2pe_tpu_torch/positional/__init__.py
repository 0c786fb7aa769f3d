from v2pe_tpu_torch.positional.v2pe import build_v2pe_pos_ids, V2PE_RND_STRIDES

__all__ = ["build_v2pe_pos_ids", "V2PE_RND_STRIDES"]
