"""Conversation / prompt templating (copy of tdc_video_tpu/data/conversation.py,
which is pure Python).

* ``qwen``: ChatML ``<|im_start|>role\\ncontent<|im_end|>\\n`` blocks.
* ``llama3_2``: the Llama-3 header format.
"""


from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    CHATML = auto()
    LLAMA_3 = auto()
    PLAIN = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    sep_style: SeparatorStyle = SeparatorStyle.CHATML
    sep: str = "<|im_end|>"
    version: str = "qwen"

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.CHATML:
            ret = "" if self.system == "" else self.system + self.sep + "\n"
            for role, message in self.messages:
                if message:
                    ret += role + "\n" + message + self.sep + "\n"
                else:
                    ret += role + "\n"
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_3:
            ret = "<|begin_of_text|>"
            ret += f"<|start_header_id|>system<|end_header_id|>\n\n{self.system}<|eot_id|>"
            for role, message in self.messages:
                if message:
                    ret += f"<|start_header_id|>{role}<|end_header_id|>\n\n{message}<|eot_id|>"
                else:
                    ret += f"<|start_header_id|>{role}<|end_header_id|>\n\n"
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            ret = self.system
            for _, message in self.messages:
                if message:
                    ret += message + self.sep
            return ret
        raise ValueError(f"Invalid style: {self.sep_style}")

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            sep_style=self.sep_style,
            sep=self.sep,
            version=self.version,
        )


conv_qwen = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="qwen",
)

conv_llama3_2 = Conversation(
    system="You are a helpful assistant.",
    roles=("user", "assistant"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_3,
    sep="<|eot_id|>",
    version="llama3_2",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    version="plain",
)

conv_templates = {
    "qwen": conv_qwen,
    "llama3_2": conv_llama3_2,
    "llama3": conv_llama3_2,
    "plain": conv_plain,
    "default": conv_qwen,
}
default_conversation = conv_qwen
