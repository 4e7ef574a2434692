"""Conversation prompt templates.

Parity: reference videollama2/conversation.py:11-503 — a prompt-format state
machine with five separator styles and a registry of named templates. Prompt
strings produced by `get_prompt` are byte-identical to the reference for each
registered template (tests/test_multimodal.py execs the reference source and
compares across the full registry).

Only the prompt logic lives here; gradio-specific image helpers live in
`serve/`.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    PLAIN = auto()
    LLAMA2 = auto()
    QWEN = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"
    skip_next: bool = False
    modality: str = "image"

    def get_prompt(self) -> str:
        messages = self.messages
        modality_token = f"<{self.modality}>"
        if len(messages) > 0 and type(messages[0][1]) is tuple:
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace(modality_token, "").strip()
            if "mmtag" in self.version:
                messages[0] = (init_role, init_msg)
                messages.insert(0, (self.roles[0], "<Image><image></Image>"))
                messages.insert(1, (self.roles[1], "Received."))
            else:
                messages[0] = (init_role, f"{modality_token}\n" + init_msg)

        def unpack(message):
            return message[0] if type(message) is tuple else message

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + unpack(message) + self.sep
                else:
                    ret += role + ":"
        elif style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + unpack(message) + seps[i % 2]
                else:
                    ret += role + ":"
        elif style == SeparatorStyle.LLAMA2:
            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], \
                        "first message should come from user"
                if message:
                    message = unpack(message)
                    if i == 0:
                        message = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" \
                                  + message
                    if i % 2 == 0:
                        ret += self.sep + f"[INST] {message} [/INST]"
                    else:
                        ret += " " + message + " " + self.sep2
            ret = ret.lstrip(self.sep) if self.sep else ret
        elif style == SeparatorStyle.QWEN:
            ret = self.system + self.sep + "\n"
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], \
                        "first message should come from user"
                if message:
                    ret += role + unpack(message) + self.sep + "\n"
                else:
                    ret += role
        elif style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + unpack(message) + seps[i % 2]
                else:
                    ret += role
        else:
            raise ValueError(f"Invalid style: {style}")
        return ret

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[x, y] for x, y in self.messages],
            offset=self.offset, sep_style=self.sep_style, sep=self.sep,
            sep2=self.sep2, version=self.version)

    def dict(self) -> dict:
        return {
            "system": self.system, "roles": self.roles,
            "messages": [[x, y[0] if type(y) is tuple else y]
                         for x, y in self.messages],
            "offset": self.offset, "sep": self.sep, "sep2": self.sep2,
            "modality": self.modality,
        }


def _conv(**kw) -> Conversation:
    kw.setdefault("messages", [])
    kw.setdefault("offset", 0)
    return Conversation(**kw)


conv_vicuna_v0 = _conv(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("Human", "Assistant"), sep_style=SeparatorStyle.SINGLE, sep="###",
    # seeded one-shot example (reference conversation.py conv_vicuna_v0
    # messages, offset=2) — part of the emitted prompt for v0/default
    messages=[
        ["Human", "What are the key differences between renewable and "
                  "non-renewable energy sources?"],
        ["Assistant",
         "Renewable energy sources are those that can be replenished "
         "naturally in a relatively short amount of time, such as solar, "
         "wind, hydro, geothermal, and biomass. Non-renewable energy "
         "sources, on the other hand, are finite and will eventually be "
         "depleted, such as coal, oil, and natural gas. Here are some key "
         "differences between renewable and non-renewable energy sources:\n"
         "1. Availability: Renewable energy sources are virtually "
         "inexhaustible, while non-renewable energy sources are finite and "
         "will eventually run out.\n"
         "2. Environmental impact: Renewable energy sources have a much "
         "lower environmental impact than non-renewable sources, which can "
         "lead to air and water pollution, greenhouse gas emissions, and "
         "other negative effects.\n"
         "3. Cost: Renewable energy sources can be more expensive to "
         "initially set up, but they typically have lower operational "
         "costs than non-renewable sources.\n"
         "4. Reliability: Renewable energy sources are often more reliable "
         "and can be used in more remote locations than non-renewable "
         "sources.\n"
         "5. Flexibility: Renewable energy sources are often more flexible "
         "and can be adapted to different situations and needs, while "
         "non-renewable sources are more rigid and inflexible.\n"
         "6. Sustainability: Renewable energy sources are more sustainable "
         "over the long term, while non-renewable sources are not, and "
         "their depletion can lead to economic and social instability.\n"],
    ],
    offset=2)

conv_llava_plain = _conv(system="", roles=("", ""),
                         sep_style=SeparatorStyle.PLAIN, sep="", sep2="\n")

conv_llava_v0 = _conv(
    system=conv_vicuna_v0.system, roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE, sep="###")

_MMTAG_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user "
    "provides, and assist the user with a variety of tasks using natural "
    "language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.")

conv_llava_v0_mmtag = _conv(
    system=_MMTAG_SYSTEM, roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE, sep="###", version="v0_mmtag")

conv_llava_v1_mmtag = _conv(
    system=_MMTAG_SYSTEM, roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>", version="v1_mmtag")

conv_vicuna_v1 = _conv(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="v1",
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_llava_v1 = _conv(
    system=conv_vicuna_v0.system, roles=("USER", "ASSISTANT"), version="v1",
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_llava_llama2 = _conv(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user "
           "provides, and assist the user with a variety of tasks using "
           "natural language.",
    roles=("USER", "ASSISTANT"), version="llama2",
    sep_style=SeparatorStyle.LLAMA2, sep="<s>", sep2="</s>")

conv_llama2 = _conv(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"), version="llama2",
    sep_style=SeparatorStyle.LLAMA2, sep="<s>", sep2="</s>")

conv_mistral = _conv(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="llama2",
    sep_style=SeparatorStyle.LLAMA2, sep="", sep2="</s>")

conv_qwen = _conv(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.QWEN, sep="<|im_end|>", version="qwen")

conv_qwen_plain = _conv(
    system="", roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    sep_style=SeparatorStyle.PLAIN, sep="<|im_end|>", sep2="<|im_end|>",
    version="qwen_plain")

default_conversation = conv_mistral
conv_templates = {
    "default": conv_vicuna_v0,
    "plain": conv_llava_plain,
    "v0": conv_vicuna_v0,
    "v0_plain": conv_llava_plain,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v0": conv_llava_v0,
    "v1": conv_vicuna_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_v1": conv_llava_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_llama2": conv_llava_llama2,
    "llama2": conv_llama2,
    "mistral": conv_mistral,
    "qwen": conv_qwen,
    "qwen_plain": conv_qwen_plain,
}
