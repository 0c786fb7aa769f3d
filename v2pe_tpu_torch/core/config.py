"""Typed configuration for v2pe_tpu_torch: the port's own copy of
``v2pe_tpu/core/config.py``, field for field.

Replaces the reference's three-layer config soup (HF ``PretrainedConfig``
subclasses + argparse dataclasses + env vars; see
the upstream ``internvl/model/internvl_chat/configuration_internvl_chat.py``
and ``configuration_internlm2.py``) with frozen dataclasses serialized to JSON.

Instance values for the two supported model families:
  * InternVL2-2B  = InternViT-300M-448px vision tower + InternLM2-1.8B decoder
  * InternVL2.5-8B = InternViT-300M-448px + InternLM2.5-7B decoder
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional


def _asdict(obj) -> dict:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class VisionConfig:
    """InternViT encoder config.

    Reference: ``internvl/model/internvl_chat/configuration_intern_vit.py:63-83``
    (class defaults there describe the 6B tower; the 300M instance used by
    InternVL2-2B is the default here).
    """

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 448
    num_channels: int = 3
    qkv_bias: bool = True
    qk_normalization: bool = False
    norm_type: str = "layer_norm"  # 'layer_norm' | 'rms_norm'
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu"
    initializer_factor: float = 0.1  # LayerScale init value
    drop_path_rate: float = 0.0
    dropout: float = 0.0
    attention_dropout: float = 0.0
    use_flash_attn: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches_per_side(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class LLMConfig:
    """Decoder config (InternLM2 defaults; ``arch`` selects the family).

    Reference: ``internvl/model/internlm2/configuration_internlm2.py:77-152``.
    Defaults are the InternLM2-1.8B (chat) instance used by InternVL2-2B.

    ``arch='deepseek_v3'`` is :class:`MLAConfig`, this class with the
    latent attention's and the experts' fields.

    ``arch='qwen2'`` mirrors the reference's composite-LLM dispatch
    (``modeling_internvl_chat.py:108-117``): Qwen2 shares this decoder's
    entire compute path — its separate q/k/v projections are repacked into
    the fused interleaved ``wqkv`` layout at conversion time (the GQA
    q-head -> kv-head mapping ``h // G`` is identical), with
    ``qkv_bias=True`` (Qwen2 biases q/k/v but not o_proj; the reference's
    qwen2_packed_training_patch.py cu_seqlens surgery is subsumed by the
    segment-id flash kernel, which is arch-agnostic).
    """

    arch: str = "internlm2"  # internlm2 | qwen2 | llama | phi3 | deepseek_v3
    vocab_size: int = 92553
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-5
    bias: bool = False       # bias on BOTH wqkv and wo (InternLM2 semantics)
    qkv_bias: bool = False   # bias on wqkv only (Qwen2 semantics)
    rope_theta: float = 1_000_000.0
    # rope_scaling['type'] analogue: 'v2pe' | 'default' | 'linear' | 'dynamic'
    rope_mode: str = "v2pe"
    rope_scaling_factor: float = 1.0
    tie_word_embeddings: bool = False
    pad_token_id: int = 2
    bos_token_id: int = 1
    eos_token_id: int = 2
    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_key_value_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclass(frozen=True)
class MLAConfig(LLMConfig):
    """The DeepSeek-V3 block (``arch='deepseek_v3'``, ``models/deepseek_v3.py``;
    defaults: Kimi-VL-A3B-Instruct's language model). Latent attention (MLA,
    no q low-rank) of ``num_attention_heads`` heads, each of
    ``qk_nope_head_dim`` + ``qk_rope_head_dim`` query/key dims and
    ``v_head_dim`` value dims, over a ``kv_lora_rank`` latent and one rotary
    key shared by the heads; the first ``first_k_dense_replace`` layers a
    dense SwiGLU of ``intermediate_size``, the rest ``n_routed_experts``
    experts of width ``moe_intermediate_size``, ``num_experts_per_tok`` a
    token (sigmoid scores; the correction bias only selects), plus
    ``n_shared_experts`` shared experts fused into one SwiGLU.
    ``num_key_value_heads`` is the heads' count, as in the HF config."""

    arch: str = "deepseek_v3"
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 131072
    rope_theta: float = 800000.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True
    first_k_dense_replace: int = 1
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """A latent pool's slot: the ``kv_lora_rank`` latent, then the
        rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def llm_config(d: dict) -> LLMConfig:
    """The decoder config of a dict: :class:`MLAConfig` for
    ``arch='deepseek_v3'``, else :class:`LLMConfig`."""
    return (MLAConfig if d.get("arch") == "deepseek_v3" else LLMConfig)(**d)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. Axes:

    * ``pipe``  — pipeline parallel over decoder-layer blocks (DCN;
                  outermost — only present when sized, parallel/pipeline.py)
    * ``data``  — data parallel (across DCN for multi-slice)
    * ``fsdp``  — parameter/optimizer sharding (ZeRO-3 analogue; ICI)
    * ``seq``   — sequence/context parallel (ring attention; ICI)
    * ``tensor``— tensor parallel over heads/ffn (ICI)

    The reference's DeepSpeed ZeRO + `chunk_num` ring groups
    (``internvl_chat_finetune.py:1104-1111``) map onto (fsdp, seq);
    it has no pipeline or tensor axis.
    """

    data: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1

    @property
    def axis_names(self) -> tuple:
        base = ("data", "fsdp", "seq", "tensor")
        return (("pipe",) + base) if self.pipe > 1 else base

    @property
    def shape(self) -> tuple:
        base = (self.data, self.fsdp, self.seq, self.tensor)
        return ((self.pipe,) + base) if self.pipe > 1 else base

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.seq * self.tensor * self.pipe


@dataclass(frozen=True)
class VLMConfig:
    """Composite InternVLChat config.

    Reference: ``internvl/model/internvl_chat/configuration_internvl_chat.py:23-99``.
    """

    vision: VisionConfig = field(default_factory=VisionConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    downsample_ratio: float = 0.5
    template: str = "internlm2-chat"
    select_layer: int = -1
    ps_version: str = "v2"  # pixel_shuffle version; 'v1' is the buggy transposed one
    dynamic_image_size: bool = True
    use_thumbnail: bool = True
    min_dynamic_patch: int = 1
    max_dynamic_patch: int = 12
    min_num_frame: int = 8
    max_num_frame: int = 32
    # V2PE knobs (persisted with checkpoints so eval reads them back,
    # mirroring configuration_internvl_chat.py:101-131)
    rope_pos_id_version: str = "v2pe_fix"  # 'default' | 'v2pe_fix' | 'v2pe_rnd'
    rope_pos_id_stride: Optional[int] = 64
    img_emb_down_sample_ratio: Optional[int] = None
    force_image_size: Optional[int] = None
    compress_seq: bool = False
    fuse_method: str = "add"        # 'add' | 'cross-attn' (finetune.py:171)
    compress_method: str = "avg"    # 'avg' | 'attention' | 'topk'
    attn_type: Optional[str] = None  # None | 'ring' | 'ulysses'
    chunk_num: int = 1

    @property
    def num_image_token(self) -> int:
        image_size = self.force_image_size or self.vision.image_size
        n = int((image_size // self.vision.patch_size) ** 2 * (self.downsample_ratio ** 2))
        if self.img_emb_down_sample_ratio is not None:
            n = int(n / self.img_emb_down_sample_ratio)
        return n

    # ------------------------------------------------------------------ json
    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "VLMConfig":
        d = json.loads(s)
        return VLMConfig.from_dict(d)

    @staticmethod
    def from_dict(d: dict) -> "VLMConfig":
        d = dict(d)
        vision = VisionConfig(**d.pop("vision", {}))
        llm = llm_config(d.pop("llm", {}))
        return VLMConfig(vision=vision, llm=llm, **d)


# --------------------------------------------------------------------------
# HF config.json bridge
# --------------------------------------------------------------------------

_HF_ARCH = {
    "InternLM2ForCausalLM": "internlm2",
    "Qwen2ForCausalLM": "qwen2",
    "LlamaForCausalLM": "llama",
    "Phi3ForCausalLM": "phi3",
    "DeepseekV3ForCausalLM": "deepseek_v3",
}


def is_hf_config(d: dict) -> bool:
    """True when `d` is an HF-hub InternVLChat config.json (the reference's
    ``InternVLChatConfig.to_dict()``: nested ``llm_config``/``vision_config``)
    rather than this framework's flat ``VLMConfig`` JSON."""
    return d.get("model_type") == "internvl_chat" or "llm_config" in d


def vlm_config_from_hf(d: dict) -> VLMConfig:
    """Derive a VLMConfig from an HF-hub InternVL snapshot's config.json.

    This is the entry point of the real-checkpoint runbook: a user points
    the CLI at a downloaded ``OpenGVLab/InternVL2-*`` directory and the
    architecture hyperparameters come from the checkpoint itself, exactly
    as the reference's ``InternVLChatConfig.from_pretrained`` does
    (``internvl/model/internvl_chat/configuration_internvl_chat.py:23-99``).
    Unknown/irrelevant HF keys (dtype, transformers_version, ...) are
    ignored; fields absent from the file keep the class defaults.
    """
    hv = d.get("vision_config") or {}
    hl = d.get("llm_config") or {}

    def pick(cls, src: dict) -> dict:
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in src.items() if k in names and v is not None}

    vision = VisionConfig(**pick(VisionConfig, hv))

    archs = hl.get("architectures") or ["InternLM2ForCausalLM"]
    arch = _HF_ARCH.get(archs[0])
    if arch is None:
        raise ValueError(f"unsupported llm architecture {archs[0]!r}; "
                         f"known: {sorted(_HF_ARCH)}")
    lkw = pick(MLAConfig if arch == "deepseek_v3" else LLMConfig, hl)
    lkw["arch"] = arch
    # HF configs omit num_key_value_heads for MHA checkpoints
    lkw.setdefault("num_key_value_heads", hl.get("num_attention_heads",
                                                 LLMConfig.num_attention_heads))
    if arch == "deepseek_v3":
        if hl.get("q_lora_rank") is not None:
            raise ValueError("deepseek_v3 with a q low-rank projection "
                             "(q_lora_rank) is not supported")
        if hl.get("rope_scaling") is not None:
            raise ValueError("deepseek_v3 with rope_scaling (yarn) is not "
                             "supported")
        if hl.get("topk_method", "noaux_tc") != "noaux_tc" or \
                hl.get("scoring_func", "sigmoid") != "sigmoid":
            raise ValueError("deepseek_v3: only sigmoid scores with "
                             "noaux_tc selection are supported")
        if hl.get("n_group", 1) != 1 or hl.get("topk_group", 1) != 1:
            raise ValueError("deepseek_v3 with grouped expert selection "
                             "(n_group or topk_group above 1) is not "
                             "supported")
    if arch == "qwen2":
        # Qwen2 biases q/k/v but not o_proj; HF's Qwen2Config carries no
        # flag for it (pre-2.5 models are always biased)
        lkw.setdefault("qkv_bias", True)
    # rope_scaling {'type','factor'} -> rope_mode/rope_scaling_factor;
    # absent => positions are consumed raw (the V2PE ids are computed by
    # the data/inference side per rope_pos_id_version, not by the decoder)
    rs = hl.get("rope_scaling")
    if isinstance(rs, dict) and rs.get("type") in ("linear", "dynamic"):
        lkw["rope_mode"] = rs["type"]
        lkw["rope_scaling_factor"] = float(rs.get("factor", 1.0))
    llm = llm_config(lkw)

    top = pick(VLMConfig, d)
    top.pop("vision", None)
    top.pop("llm", None)
    # an explicit null stride must override the preset default (vanilla
    # non-V2PE snapshots ship "rope_pos_id_stride": null)
    if "rope_pos_id_stride" in d:
        top["rope_pos_id_stride"] = d["rope_pos_id_stride"]
    # the HF field is force_image_size; some snapshots carry image_size on
    # the vision config only (handled by `vision` above)
    return VLMConfig(vision=vision, llm=llm, **top)


def load_vlm_config(path: str) -> VLMConfig:
    """Read a config.json that is either this framework's VLMConfig JSON
    (written next to every checkpoint by the trainer) or an HF-hub
    InternVLChat config.json, detected by shape."""
    with open(path) as f:
        d = json.load(f)
    return vlm_config_from_hf(d) if is_hf_config(d) else VLMConfig.from_dict(d)


# --------------------------------------------------------------------------
# Presets
# --------------------------------------------------------------------------

def internvl2_2b() -> VLMConfig:
    """InternVL2-2B (the V2PE flagship): InternViT-300M + InternLM2-1.8B."""
    return VLMConfig()


def internvl2_5_8b() -> VLMConfig:
    """InternVL2.5-8B: InternViT-300M + InternLM2.5-7B (GQA 32/8).

    Mirrors the internvl2_5 fork (upstream ``internvl2_5``; §2.9 of
    SURVEY.md) parameterized by size rather than forked.
    """
    return VLMConfig(
        llm=LLMConfig(
            vocab_size=92553,
            hidden_size=4096,
            intermediate_size=14336,
            num_hidden_layers=32,
            num_attention_heads=32,
            num_key_value_heads=8,
            rope_theta=1_000_000.0,
        ),
        template="internvl2_5",
    )


def debug_tiny(vocab_size: int = 92553) -> VLMConfig:
    """2-layer debug config, analogue of the reference's DEBUG_FLAG=1 path
    (``internvl_chat_finetune.py:1200-1255``)."""
    return VLMConfig(
        vision=VisionConfig(
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            image_size=448,
            patch_size=14,
        ),
        llm=LLMConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
        ),
    )
