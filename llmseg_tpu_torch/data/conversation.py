"""Conversation templates, a copy of ``llmseg_tpu.data.conversation``
(capability parity with reference
model/llava/conversation.py:6-399; the active template is llava_v1,
selected via training.py:110-115)."""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    LLAMA_2 = auto()
    PLAIN = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "Unknown"

    def get_prompt(self) -> str:
        messages = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if self.sep_style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(message)
                    else:
                        ret += " " + message + " " + self.sep2
            return ret.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += message + seps[i % 2]
            return ret
        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message: str):
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages], offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            version=self.version)


conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the human's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[],
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. You are able to "
           "understand the visual content that the user provides, and assist "
           "the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"), version="llama_v2", messages=[],
    sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_plain = Conversation(system="", roles=("", ""), version="plain",
                          messages=[], sep_style=SeparatorStyle.PLAIN,
                          sep="\n")

conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_v1": conv_llava_v1,
    "llava_llama_2": conv_llava_llama_2,
    "plain": conv_plain,
}

default_conversation = conv_llava_v1


def get_default_conv_template(name: str = "llava_v1") -> Conversation:
    return conv_templates[name].copy()
