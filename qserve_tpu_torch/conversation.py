"""Chat prompt templating (a copy of qserve_tpu/conversation.py).

Original, compact design: each template is data (role tags, separators,
system slot) interpreted by one renderer, instead of a per-style enum switch.
Covers the model families the reference serves: Llama-2/3 chat, Vicuna, Yi /
Qwen (ChatML), Mistral instruct, and the VILA/LLaVA vision templates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Conversation:
    """A chat template plus accumulated messages."""

    name: str
    system_template: str = "{system}"
    system: str = ""
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    role_templates: Tuple[str, str] = ("{role}: {msg}", "{role}: {msg}")
    sep: str = "\n"  # after each complete message
    sep2: Optional[str] = None  # after assistant turns (if different)
    stop_str: Optional[List[str]] = None
    messages: List[Tuple[str, Optional[str]]] = dataclasses.field(default_factory=list)

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=list(self.messages))

    def set_system_message(self, msg: str) -> None:
        self.system = msg

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append((role, message))

    def update_last_message(self, message: str) -> None:
        self.messages[-1] = (self.messages[-1][0], message)

    def get_prompt(self) -> str:
        parts = []
        if self.system:
            parts.append(self.system_template.format(system=self.system))
            parts.append(self.sep)
        seps = [self.sep, self.sep2 if self.sep2 is not None else self.sep]
        for i, (role, msg) in enumerate(self.messages):
            ridx = 0 if role == self.roles[0] else 1
            tmpl = self.role_templates[ridx]
            if msg is None:
                # open assistant turn: emit the role prefix only
                head = tmpl.split("{msg}")[0]
                parts.append(head.format(role=role, msg=""))
            else:
                parts.append(tmpl.format(role=role, msg=msg))
                parts.append(seps[ridx])
        return "".join(parts)


_REGISTRY: Dict[str, Conversation] = {}


def register_conv_template(conv: Conversation) -> None:
    _REGISTRY[conv.name] = conv


def get_conv_template(name: str) -> Conversation:
    return _REGISTRY[name].copy()


register_conv_template(Conversation(
    name="vicuna_v1.1",
    system=("A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."),
    roles=("USER", "ASSISTANT"),
    role_templates=("{role}: {msg}", "{role}: {msg}"),
    sep=" ",
    sep2="</s>",
    stop_str=["</s>"],
))

register_conv_template(Conversation(
    name="llama-2",
    system_template="[INST] <<SYS>>\n{system}\n<</SYS>>\n\n",
    system="You are a helpful assistant.",
    roles=("[INST]", "[/INST]"),
    role_templates=("[INST] {msg}", " [/INST] {msg}"),
    sep="",
    sep2=" </s><s>",
    stop_str=["</s>"],
))

register_conv_template(Conversation(
    name="llama-3",
    system_template=(
        "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
        "{system}<|eot_id|>"
    ),
    system="You are a helpful assistant.",
    roles=("user", "assistant"),
    role_templates=(
        "<|start_header_id|>user<|end_header_id|>\n\n{msg}<|eot_id|>",
        "<|start_header_id|>assistant<|end_header_id|>\n\n{msg}",
    ),
    sep="",
    sep2="<|eot_id|>",
    stop_str=["<|eot_id|>", "<|end_of_text|>"],
))

register_conv_template(Conversation(
    name="chatml",  # Qwen / Yi chat
    system_template="<|im_start|>system\n{system}<|im_end|>",
    system="You are a helpful assistant.",
    roles=("user", "assistant"),
    role_templates=(
        "<|im_start|>user\n{msg}<|im_end|>",
        "<|im_start|>assistant\n{msg}",
    ),
    sep="\n",
    sep2="<|im_end|>\n",
    stop_str=["<|im_end|>"],
))

register_conv_template(Conversation(
    name="mistral",
    roles=("[INST]", "[/INST]"),
    role_templates=("[INST] {msg}", " [/INST] {msg}"),
    sep="",
    sep2="</s>",
    stop_str=["</s>"],
))

register_conv_template(Conversation(
    name="vila_v1",  # VILA / LLaVA-1.5 style (vicuna base + <image> tokens)
    system=("A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."),
    roles=("USER", "ASSISTANT"),
    role_templates=("{role}: {msg}", "{role}: {msg}"),
    sep=" ",
    sep2="</s>",
    stop_str=["</s>"],
))

register_conv_template(Conversation(
    name="plain",  # raw completion, no chat structure
    roles=("", ""),
    role_templates=("{msg}", "{msg}"),
    sep="",
))


def get_conv_template_name(model_path: str) -> str:
    """Map a model path to a template (reference conversation.py:12-26)."""
    p = model_path.lower()
    if "vila" in p or "llava" in p:
        return "vila_v1"
    if "llama-3" in p or "llama3" in p:
        return "llama-3"
    if "llama-2" in p or "llama2" in p:
        return "llama-2"
    if "vicuna" in p:
        return "vicuna_v1.1"
    if "qwen" in p or "yi-" in p or "/yi" in p:
        return "chatml"
    if "mistral" in p or "mixtral" in p:
        return "mistral"
    return "plain"
