"""The decoder a config names, behind one interface: the dense GQA blocks
(``internlm2.py``: InternLM2, Qwen2, Llama, Phi-3) or the DeepSeek-V3 block
(``deepseek_v3.py``: latent attention and experts). Both take
``internlm2.llm_forward``'s arguments and hold ``tok_embeddings``,
``layers``, ``norm`` and ``output``."""

from __future__ import annotations

from torch import nn

from v2pe_tpu_torch.core.config import LLMConfig
from v2pe_tpu_torch.models import deepseek_v3, internlm2


def is_mla(cfg: LLMConfig) -> bool:
    """The DeepSeek-V3 block (latent attention and experts): ``arch``
    'deepseek_v3' (read by name: callers may hold the JAX package's config
    objects, which have the same fields)."""
    return getattr(cfg, "arch", None) == "deepseek_v3"


def build(cfg: LLMConfig) -> nn.Module:
    return deepseek_v3.DeepseekV3Model(cfg) if is_mla(cfg) else \
        internlm2.InternLM2Model(cfg)


def llm_forward(model, cfg: LLMConfig, **kw):
    """``internlm2.llm_forward`` or ``deepseek_v3.llm_forward`` by the
    config's ``arch``."""
    fwd = deepseek_v3.llm_forward if is_mla(cfg) else internlm2.llm_forward
    return fwd(model, cfg, **kw)
