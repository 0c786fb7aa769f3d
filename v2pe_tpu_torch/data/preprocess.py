"""Tokenization + assistant-only label masking.

Behavior parity with the reference's four masking routines
(``internvl/train/dataset.py:335-727``): apply the chat template, replace
each ``<image>`` with ``<img> + <IMG_CONTEXT>*n + </img>``, tokenize, and
mask everything except assistant answers to IGNORE (-100) by re-tokenizing
turn fragments; on a length mismatch the whole sample is masked with a
warning. The four variants differ in turn-splitting arithmetic:

- ``preprocess_internlm`` (:640-727) — internlm2-chat / internvl2_5
- ``preprocess`` (:335-438) — llama/vicuna ADD_COLON_TWO templates
- ``preprocess_mpt`` (:441-530) — Hermes-2
- ``preprocess_phi3`` (:533-637) — phi3-chat

``get_preprocess_function`` mirrors the template dispatch at
``internvl/train/internvl_chat_finetune.py:520-527``."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from v2pe_tpu_torch.data.constants import (IGNORE_TOKEN_ID, IMG_CONTEXT_TOKEN,
                                     IMG_END_TOKEN, IMG_START_TOKEN)
from v2pe_tpu_torch.data.conversation import get_conv_template

logger = logging.getLogger(__name__)


def build_prompt(template_name: str, source: Sequence[dict],
                 strip: bool = True) -> str:
    """source: [{'from': 'human'|'gpt', 'value': str}, ...].

    ``preprocess_internlm`` strips message values (dataset.py:662); the
    llama/mpt/phi3 variants pass them through verbatim (:360, :466, :558).
    """
    conv = get_conv_template(template_name)
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles[source[0]["from"]] != conv.roles[0]:
        source = source[1:]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], "conversation roles must alternate"
        value = sentence["value"].strip() if strip else sentence["value"]
        conv.append_message(role, value)
    return conv.get_prompt()


def expand_image_tokens(conversation: str,
                        num_image_token_list: Sequence[int]) -> str:
    """Replace each '<image>' in order with its <img>...</img> span."""
    for n in num_image_token_list:
        image_tokens = f"{IMG_START_TOKEN}{IMG_CONTEXT_TOKEN * n}{IMG_END_TOKEN}"
        conversation = conversation.replace("<image>", image_tokens, 1)
    return conversation


def preprocess_internlm(
    template_name: str,
    sources: Sequence[Sequence[dict]],
    tokenizer,
    num_image_token_list: Sequence[int],
    *,
    text_only: bool = False,
    ds_name: Optional[str] = None,
    num_image: int = 1,
    max_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Returns dict(input_ids (B,S), labels (B,S), attention_mask (B,S))
    as numpy (no padding — packing handles static shapes downstream)."""
    conv = get_conv_template(template_name)
    conversations = [build_prompt(template_name, s) for s in sources]
    if not text_only:
        conversations = [
            expand_image_tokens(c, num_image_token_list[:num_image])
            for c in conversations
        ]

    enc = tokenizer(conversations, truncation=max_length is not None,
                    max_length=max_length)
    all_ids, all_labels, all_masks = [], [], []
    for conversation, ids in zip(conversations, enc["input_ids"]):
        ids = np.asarray(ids, dtype=np.int64)
        target = ids.copy()
        total_len = int((ids != tokenizer.pad_token_id).sum())

        cur_len = 1
        target[:cur_len] = IGNORE_TOKEN_ID  # <s>
        parts = conversation.split(conv.roles[1])
        info = parts[0] + conv.roles[1]
        temp_len = len(tokenizer(info)["input_ids"]) - 1
        target[cur_len:cur_len + temp_len] = IGNORE_TOKEN_ID
        cur_len += temp_len

        for index in range(1, len(parts) - 1):
            info = parts[index]
            part1, part2 = info.split(conv.roles[0])
            temp_len = len(tokenizer(part1)["input_ids"]) - 1
            cur_len += temp_len
            part = conv.roles[0] + part2 + conv.roles[1]
            temp_len = len(tokenizer(part)["input_ids"]) - 1
            target[cur_len:cur_len + temp_len] = IGNORE_TOKEN_ID
            cur_len += temp_len
        last_info = parts[-1]
        temp_len = len(tokenizer(last_info)["input_ids"]) - 1
        cur_len += temp_len

        target[cur_len:] = IGNORE_TOKEN_ID
        if cur_len != total_len:
            target[:] = IGNORE_TOKEN_ID
            logger.warning(
                "tokenization mismatch: %d vs. %d (dataset %s)",
                cur_len, total_len, ds_name)

        all_ids.append(ids)
        all_labels.append(target)
        all_masks.append((ids != tokenizer.pad_token_id).astype(np.int64))

    return {
        "input_ids": all_ids,
        "labels": all_labels,
        "attention_mask": all_masks,
    }


def _tokenize_batch(conversations, tokenizer, max_length):
    enc = tokenizer(conversations, truncation=max_length is not None,
                    max_length=max_length)
    return [np.asarray(ids, dtype=np.int64) for ids in enc["input_ids"]]


def _finish(tokenizer, all_ids, all_labels):
    masks = [(ids != tokenizer.pad_token_id).astype(np.int64)
             for ids in all_ids]
    return {"input_ids": all_ids, "labels": all_labels,
            "attention_mask": masks}


def _mismatch_guard(target, cur_len, total_len, model_max_length, ds_name,
                    n_turns):
    """dataset.py:425-432 — zero the sample on a turn-arithmetic mismatch,
    unless the sequence was truncated at model_max_length."""
    if cur_len < model_max_length and cur_len != total_len:
        target[:] = IGNORE_TOKEN_ID
        logger.warning(
            "tokenization mismatch: %d vs. %d. #turn = %d (ignored, "
            "dataset %s)", cur_len, total_len, n_turns, ds_name)


def preprocess(
    template_name: str,
    sources: Sequence[Sequence[dict]],
    tokenizer,
    num_image_token_list: Sequence[int],
    *,
    text_only: bool = False,
    ds_name: Optional[str] = None,
    num_image: int = 1,
    max_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Llama/vicuna ADD_COLON_TWO masking (dataset.py:335-438).

    Turns are split on ``sep2`` (``</s>``); within each turn the
    instruction ends at ``sep + roles[1] + ': '`` and its token length is
    corrected by the hardcoded llama-tokenizer offsets (-2, and -1 per
    later turn for non-legacy tokenizers, :402-415). ``tokenizer.legacy``
    defaults to True when absent (non-llama tokenizers)."""
    conv = get_conv_template(template_name)
    conversations = [build_prompt(template_name, s, strip=False)
                     for s in sources]
    if not text_only:
        conversations = [
            expand_image_tokens(c, num_image_token_list[:num_image])
            for c in conversations
        ]

    all_ids = _tokenize_batch(conversations, tokenizer, max_length)
    legacy = getattr(tokenizer, "legacy", True)
    sep = conv.sep + conv.roles[1] + ": "
    all_labels = []
    for conversation, ids in zip(conversations, all_ids):
        target = ids.copy()
        total_len = int((ids != tokenizer.pad_token_id).sum())

        turns = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_TOKEN_ID
        for i, turn in enumerate(turns):
            if turn == "":
                break
            turn_len = len(tokenizer(turn)["input_ids"])

            parts = turn.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            # "-2" is hardcoded for the llama tokenizer (dataset.py:402-403)
            instruction_len = len(tokenizer(parts[0])["input_ids"]) - 2
            if i != 0 and not legacy:
                instruction_len -= 1

            target[cur_len:cur_len + instruction_len] = IGNORE_TOKEN_ID
            cur_len += turn_len
            if i != 0 and not legacy:
                cur_len -= 1

        target[cur_len:] = IGNORE_TOKEN_ID
        _mismatch_guard(target, cur_len, total_len,
                        tokenizer.model_max_length, ds_name, len(turns) - 1)
        all_labels.append(target)

    return _finish(tokenizer, all_ids, all_labels)


def _regroup_turns(turns: List[str], sep: str) -> List[str]:
    """dataset.py:495-497 — [system+user+gpt, then (user+gpt) pairs]."""
    re_turns = [sep.join(turns[:3])]
    for conv_idx in range(3, len(turns), 2):
        re_turns.append(sep.join(turns[conv_idx:conv_idx + 2]))
    return re_turns


def preprocess_mpt(
    template_name: str,
    sources: Sequence[Sequence[dict]],
    tokenizer,
    num_image_token_list: Sequence[int],
    *,
    text_only: bool = False,
    ds_name: Optional[str] = None,
    num_image: int = 1,
    max_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Hermes-2/MPT masking (dataset.py:441-530): regrouped turns split on
    ``sep`` (``<|im_end|>``), turn_len counts tokens +1, cur_len starts 0."""
    conv = get_conv_template(template_name)
    conversations = [build_prompt(template_name, s, strip=False)
                     for s in sources]
    if not text_only:
        conversations = [
            expand_image_tokens(c, num_image_token_list[:num_image])
            for c in conversations
        ]

    all_ids = _tokenize_batch(conversations, tokenizer, max_length)
    sep = conv.sep + conv.roles[1]  # <|im_end|><|im_start|>assistant\n
    all_labels = []
    for conversation, ids in zip(conversations, all_ids):
        target = ids.copy()
        total_len = int((ids != tokenizer.pad_token_id).sum())

        turns = conversation.split(conv.sep)
        re_turns = _regroup_turns(turns, conv.sep)
        cur_len = 0
        for i, turn in enumerate(re_turns):
            if turn == "":
                break
            turn_len = len(tokenizer(turn)["input_ids"]) + 1

            parts = turn.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            instruction_len = len(tokenizer(parts[0])["input_ids"])

            target[cur_len:cur_len + instruction_len] = IGNORE_TOKEN_ID
            cur_len += turn_len

        target[cur_len:] = IGNORE_TOKEN_ID
        _mismatch_guard(target, cur_len, total_len,
                        tokenizer.model_max_length, ds_name, len(turns) - 1)
        all_labels.append(target)

    return _finish(tokenizer, all_ids, all_labels)


def preprocess_phi3(
    template_name: str,
    sources: Sequence[Sequence[dict]],
    tokenizer,
    num_image_token_list: Sequence[int],
    *,
    text_only: bool = False,
    ds_name: Optional[str] = None,
    num_image: int = 1,
    max_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Phi-3 masking (dataset.py:533-637): like mpt but cur_len starts 1,
    ``<|endoftext|>`` ids are force-masked, and first-vs-later turns carry
    different token-length offsets (:599-611)."""
    conv = get_conv_template(template_name)
    conversations = [build_prompt(template_name, s, strip=False)
                     for s in sources]
    if not text_only:
        conversations = [
            expand_image_tokens(c, num_image_token_list[:num_image])
            for c in conversations
        ]

    tokenizer.padding_side = "right"
    all_ids = _tokenize_batch(conversations, tokenizer, max_length)
    sep = conv.sep + conv.roles[1]  # <|end|><|assistant|>\n
    endoftext_id = tokenizer.convert_tokens_to_ids("<|endoftext|>")
    all_labels = []
    for conversation, ids in zip(conversations, all_ids):
        target = ids.copy()
        total_len = int((ids != int(tokenizer.pad_token_id)).sum())

        turns = conversation.split(conv.sep)
        re_turns = _regroup_turns(turns, conv.sep)
        cur_len = 1
        target[:cur_len] = IGNORE_TOKEN_ID
        target[target == endoftext_id] = IGNORE_TOKEN_ID

        for i, turn in enumerate(re_turns):
            if turn == "":
                break
            if i == 0:
                turn_len = len(tokenizer(turn)["input_ids"])
            else:
                turn_len = len(tokenizer(turn)["input_ids"]) - 1
            parts = turn.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep

            if i == 0:
                instruction_len = len(tokenizer(parts[0])["input_ids"]) - 1
            else:
                instruction_len = len(tokenizer(parts[0])["input_ids"]) - 2

            target[cur_len:cur_len + instruction_len] = IGNORE_TOKEN_ID
            cur_len += turn_len

        target[cur_len:] = IGNORE_TOKEN_ID
        _mismatch_guard(target, cur_len, total_len,
                        tokenizer.model_max_length, ds_name, len(turns) - 1)
        all_labels.append(target)

    return _finish(tokenizer, all_ids, all_labels)


def get_preprocess_function(template_name: str):
    """Template → masking routine (internvl_chat_finetune.py:520-527)."""
    if template_name == "Hermes-2":
        return preprocess_mpt
    if template_name.startswith(("internlm2", "internvl2_5")):
        return preprocess_internlm
    if template_name == "phi3-chat":
        return preprocess_phi3
    return preprocess
