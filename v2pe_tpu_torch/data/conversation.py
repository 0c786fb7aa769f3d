"""Chat templating.

Minimal registry with the templates V2PE actually trains on (the reference
vendors ~40 fastchat templates in conversation.py; the four with a
label-masking routine are ``internlm2-chat``/``internvl2_5`` plus
``Hermes-2`` (mpt), ``phi3-chat`` and ``vicuna_v1.1`` (llama), matching the
dispatch in ``internvl/train/internvl_chat_finetune.py:520-527``). Prompt
strings match ``internvl/conversation.py`` exactly: MPT separator style
``:239-248``, ADD_COLON_TWO ``:73-81``."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Conversation:
    name: str
    system_template: str
    system_message: str
    roles: Tuple[str, str]
    sep: str
    sep2: Optional[str] = None
    sep_style: str = "mpt"  # "mpt" | "add_colon_two"
    stop_token_ids: Tuple[int, ...] = ()
    stop_str: Optional[str] = None
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(
        default_factory=list)

    @property
    def system_prompt(self) -> str:
        return self.system_template.format(system_message=self.system_message)

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append((role, message))

    def get_prompt(self) -> str:
        """MPT (conversation.py:239-248) or ADD_COLON_TWO (:73-81) style."""
        if self.sep_style == "add_colon_two":
            seps = [self.sep, self.sep2]
            ret = self.system_prompt + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        ret = self.system_prompt + self.sep
        for role, message in self.messages:
            if message:
                ret += role + message + self.sep
            else:
                ret += role
        return ret

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))


_REGISTRY = {}


def register_conv_template(conv: Conversation):
    _REGISTRY[conv.name] = conv


def get_conv_template(name: str) -> Conversation:
    return _REGISTRY[name].copy()


register_conv_template(Conversation(
    name="internlm2-chat",
    system_template="<|im_start|>system\n{system_message}",
    system_message=(
        "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，英文名叫InternVL, "
        "是一个有用无害的人工智能助手。"),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep="<|im_end|>",
    stop_token_ids=(2, 1163, 92543, 92542),
))

# MPT-family template (conversation.py:722-738) — masked by preprocess_mpt.
register_conv_template(Conversation(
    name="Hermes-2",
    system_template="<|im_start|>system\n{system_message}",
    system_message=(
        "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，英文名叫InternVL, "
        "是一个有用无害的人工智能助手。"),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep="<|im_end|>",
    stop_token_ids=(2, 6, 7, 8),
    stop_str="<|endoftext|>",
))

# Phi-3 template (conversation.py:794-809) — masked by preprocess_phi3.
register_conv_template(Conversation(
    name="phi3-chat",
    system_template="<|system|>\n{system_message}",
    system_message=(
        "你是由上海人工智能实验室联合商汤科技开发的书生多模态大模型，英文名叫InternVL, "
        "是一个有用无害的人工智能助手。"),
    roles=("<|user|>\n", "<|assistant|>\n"),
    sep="<|end|>",
    stop_token_ids=(2, 32000, 32007),
))

# Vicuna/Llama template (conversation.py:402-411, ADD_COLON_TWO) — masked by
# the llama-style ``preprocess``.
register_conv_template(Conversation(
    name="vicuna_v1.1",
    system_template="{system_message}",
    system_message=(
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions."),
    roles=("USER", "ASSISTANT"),
    sep=" ",
    sep2="</s>",
    sep_style="add_colon_two",
))

# InternVL2.5 template (internvl2_5/conversation.py:1324-1333): same MPT
# structure, updated system message, sep includes the trailing newline, and
# no explicit stop_token_ids (generation falls back to the model eos).
register_conv_template(Conversation(
    name="internvl2_5",
    system_template="<|im_start|>system\n{system_message}",
    system_message=(
        "你是书生·万象，英文名是InternVL，是由上海人工智能实验室、清华大学及多家合作单位"
        "联合开发的多模态大语言模型。"),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep="<|im_end|>\n",
    stop_token_ids=(),
))
