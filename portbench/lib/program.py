"""The system under test, the PyTorch port ``v2pe_tpu_torch``: the one
module of the benchmark that imports it. It builds the port's model around
the benchmark's weights and its serving engine; nothing here measures."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def load() -> None:
    """Import the port's modules that the serving path runs."""
    import v2pe_tpu_torch.infer.chat  # noqa: F401
    import v2pe_tpu_torch.serve.engine  # noqa: F401


def vlm_config(model: dict):
    from v2pe_tpu_torch.core.config import VLMConfig

    return VLMConfig.from_dict(model)


def build_model(cfg, params: Dict[str, torch.Tensor]):
    """The port's ``InternVLChatModel`` holding ``params`` as they are (no
    copy): built on the meta device, then each parameter replaced by the
    benchmark's tensor. Raises when the names or shapes differ."""
    from v2pe_tpu_torch.models.internvl_chat import InternVLChatModel

    with torch.device("meta"):
        model = InternVLChatModel(cfg)
    names = dict(model.named_parameters())
    if set(names) != set(params):
        raise ValueError(
            f"the port's parameters differ from the benchmark's layout: "
            f"only the port's {sorted(set(names) - set(params))[:5]}, only "
            f"the benchmark's {sorted(set(params) - set(names))[:5]}")
    for name, value in params.items():
        if tuple(names[name].shape) != tuple(value.shape):
            raise ValueError(f"{name}: the port's {tuple(names[name].shape)}"
                             f" against {tuple(value.shape)}")
        owner, leaf = model, name
        if "." in name:
            path, leaf = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        owner._parameters[leaf] = nn.Parameter(value, requires_grad=False)
    return model.eval()


def engine(model, cfg, tokenizer, seed: int, engine_kw: dict):
    """An ``InferenceEngine`` over a ``ChatModel``: greedy, and no stop
    token, so every answer runs to its ``max_new_tokens``."""
    from v2pe_tpu_torch.infer.chat import ChatModel
    from v2pe_tpu_torch.infer.generate import GenerationConfig
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    chat = ChatModel(model, cfg, tokenizer)
    dev = next(model.parameters()).device
    gc = GenerationConfig(do_sample=False, eos_token_ids=(-1,))
    return InferenceEngine(
        chat, generation_config=gc,
        generator=torch.Generator(device=dev).manual_seed(
            int(seed) % (1 << 63)), **engine_kw)


def kernel_launches() -> Dict[str, int]:
    """The port's launch counters, by kernel, as it keeps them."""
    from v2pe_tpu_torch.ops import flash_fwd, paged_attention

    out = {"flash_fwd": flash_fwd.LAUNCHES}
    out.update(paged_attention.LAUNCHES)
    return out


def build_seconds() -> float:
    """Seconds the port spent compiling its kernels in this process (0 when
    the checkout's build was there)."""
    from v2pe_tpu_torch.ops import _build

    return _build.build_seconds
