"""HF-compatible chat surface (port of ``v2pe_tpu/infer/chat.py``):
conversation templating with history, '<image>' expanded to
'<img>' + <IMG_CONTEXT> * num_image_token * tiles + '</img>', V2PE position
ids from ``v2pe_tpu.positional``, and decode through
``infer/generate.py``."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from v2pe_tpu.core.config import VLMConfig
from v2pe_tpu.data.constants import (IMG_CONTEXT_TOKEN, IMG_END_TOKEN,
                                     IMG_START_TOKEN)
from v2pe_tpu.data.conversation import get_conv_template
from v2pe_tpu.data.tiling import dynamic_preprocess
from v2pe_tpu.data.transforms import build_transform
from v2pe_tpu.positional import build_v2pe_pos_ids
from v2pe_tpu_torch.infer.generate import GenerationConfig, generate


class ChatModel:
    """Holds the model, its config and a tokenizer; chat()/batch_chat() with
    the reference's semantics. ``cache_mode="paged"`` decodes through the
    paged-KV kernels (``ops/paged_attention.py``) from a pool of
    ``page_size``-token pages, in the model's dtype or, with
    ``kv_dtype="int8"``, quantized. Unquantized weights only for now."""

    def __init__(self, model, cfg: VLMConfig, tokenizer,
                 cache_mode: str = "dense", page_size: int = 128,
                 kv_dtype=None, weights_dtype=None, lora=None):
        if cache_mode not in ("dense", "paged"):
            raise NotImplementedError(f"cache_mode={cache_mode!r}")
        if kv_dtype not in (None, "int8"):
            raise NotImplementedError(f"kv_dtype={kv_dtype!r}: int4 pools "
                                      f"are not ported")
        if weights_dtype is not None:
            raise NotImplementedError(f"weights_dtype={weights_dtype!r}")
        if lora is not None:
            raise NotImplementedError("LoRA merge is not ported yet")
        self.model = model
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.cache_mode = cache_mode
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.img_context_token_id = tokenizer.convert_tokens_to_ids(
            IMG_CONTEXT_TOKEN)
        self.img_start_id = tokenizer.convert_tokens_to_ids(IMG_START_TOKEN)
        self.img_end_id = tokenizer.convert_tokens_to_ids(IMG_END_TOKEN)
        self.conv_template = get_conv_template(cfg.template)
        self.system_message = self.conv_template.system_message

    # ------------------------------------------------------------- images
    def load_pixels(self, image, max_num: Optional[int] = None):
        """PIL image -> (tiles (n, 3, sz, sz) float32, num_tiles)."""
        sz = self.cfg.force_image_size or self.cfg.vision.image_size
        tiles = dynamic_preprocess(
            image, min_num=self.cfg.min_dynamic_patch,
            max_num=max_num or self.cfg.max_dynamic_patch,
            image_size=sz, use_thumbnail=self.cfg.use_thumbnail,
        ) if self.cfg.dynamic_image_size else [image]
        transform = build_transform(is_train=False, input_size=sz)
        return np.stack([transform(t) for t in tiles]), len(tiles)

    # -------------------------------------------------------------- prompt
    def build_query(self, question: str, num_patches_list: Sequence[int],
                    history=None) -> str:
        conv = self.conv_template.copy()
        conv.system_message = self.system_message
        for old_q, old_a in (history or []):
            conv.append_message(conv.roles[0], old_q)
            conv.append_message(conv.roles[1], old_a)
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)
        query = conv.get_prompt()
        for num_patches in num_patches_list:
            tokens = (IMG_START_TOKEN
                      + IMG_CONTEXT_TOKEN * self.cfg.num_image_token
                      * num_patches + IMG_END_TOKEN)
            query = query.replace("<image>", tokens, 1)
        return query

    def encode_chat(self, question: str, num_patches_list, history=None,
                    rope_pos_id_version: Optional[str] = None,
                    rope_pos_id_stride: Optional[int] = None):
        """Template + tokenize + V2PE positions for one turn: (ids int64,
        pos float32, query str)."""
        query = self.build_query(question, num_patches_list, history)
        ids = np.asarray(self.tokenizer(query)["input_ids"], np.int64)
        version = rope_pos_id_version or self.cfg.rope_pos_id_version
        stride = rope_pos_id_stride or self.cfg.rope_pos_id_stride
        if num_patches_list and version != "default":
            pos = build_v2pe_pos_ids(
                ids, np.ones_like(ids), num_patches_list,
                img_start_id=self.img_start_id, img_end_id=self.img_end_id,
                num_image_token=self.cfg.num_image_token,
                version=version, stride=stride)
        else:
            pos = np.arange(len(ids), dtype=np.float32)
        return ids, pos.astype(np.float32), query

    # ---------------------------------------------------------------- chat
    def chat(self, pixel_values, question: str,
             generation_config: Optional[GenerationConfig] = None,
             history: Optional[List[Tuple[str, str]]] = None,
             return_history: bool = False,
             num_patches_list: Optional[Sequence[int]] = None,
             rope_pos_id_version: Optional[str] = None,
             rope_pos_id_stride: Optional[int] = None,
             verbose: bool = False):
        """pixel_values: (T, 3, sz, sz) array or tensor, or None for text."""
        if num_patches_list is None:
            num_patches_list = [pixel_values.shape[0]] \
                if pixel_values is not None else []
        # the '<image>' marker stays in the question, so history keeps it
        if history is None and pixel_values is not None \
                and "<image>" not in question:
            question = "<image>\n" + question
        ids, pos, query = self.encode_chat(
            question, num_patches_list, history,
            rope_pos_id_version=rope_pos_id_version,
            rope_pos_id_stride=rope_pos_id_stride)

        gc = generation_config or GenerationConfig()
        if gc.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        stop_ids = tuple(self.conv_template.stop_token_ids) or \
            (self.cfg.llm.eos_token_id,)
        gc = dataclasses.replace(gc, eos_token_ids=stop_ids)

        if pixel_values is None:
            sz = self.cfg.force_image_size or self.cfg.vision.image_size
            pixel_values = torch.zeros((1, 3, sz, sz))
            flags = torch.zeros((1,), dtype=torch.int32)
        else:
            pixel_values = torch.as_tensor(pixel_values)
            flags = torch.ones((pixel_values.shape[0],), dtype=torch.int32)

        tokens, _, gen_lens = generate(
            self.model, self.cfg, gc, torch.as_tensor(ids[None]),
            torch.tensor([len(ids)]), torch.as_tensor(pos[None]),
            pixel_values, flags, self.img_context_token_id,
            cache_mode=self.cache_mode, page_size=self.page_size,
            kv_dtype=self.kv_dtype)
        response = self._decode(tokens[0].cpu().numpy(), int(gen_lens[0]))
        history = list(history or []) + [(question, response)]
        if verbose:
            print(f"{query!r} -> {response!r}")
        if return_history:
            return response, history
        return response

    def batch_chat(self, pixel_values_list, questions,
                   generation_config=None, num_patches_lists=None, **kw):
        """No-history batched chat: one chat() per item."""
        out = []
        for i, q in enumerate(questions):
            pv = pixel_values_list[i] if pixel_values_list else None
            npl = num_patches_lists[i] if num_patches_lists else None
            out.append(self.chat(pv, q, generation_config,
                                 num_patches_list=npl, **kw))
        return out

    def _decode(self, token_ids: np.ndarray, gen_len: int) -> str:
        """Keep the row's gen_len tokens (id 0 may be a real token), drop a
        trailing stop token, detokenize up to the separator."""
        stop = set(self.conv_template.stop_token_ids)
        keep = [int(t) for t in token_ids[:gen_len]]
        while keep and keep[-1] in stop:
            keep.pop()
        text = self.tokenizer.decode(keep, skip_special_tokens=True)
        return text.split(self.conv_template.sep)[0].strip()
