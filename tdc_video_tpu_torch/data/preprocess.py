"""Chat tokenization with label masking and <image> splicing (port of
tdc_video_tpu/data/preprocess.py, which is pure Python and numpy).

`preprocess` dispatches to the Qwen (ChatML) or Llama-3 header templates;
both give assistant-only labels (IGNORE_INDEX elsewhere, except the
structural special tokens) and the plain user prompts for the Q-Former.
`pack_text` right-pads rows to a fixed length and locates the <image> slot.
The tokenizer is anything with `encode(text) -> List[int]`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN, IGNORE_INDEX, IMAGE_TOKEN_INDEX


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Per-family special token ids used for label unmasking (reference
    preprocess_qwen :667 / preprocess_llama3 :745-760)."""

    im_start: int = 151644
    im_end: int = 151645
    newline: int = 198
    bos: Optional[int] = None
    start_header: Optional[int] = None
    end_header: Optional[int] = None
    eot: Optional[int] = None


QWEN_SPECIALS = SpecialTokens()
LLAMA3_SPECIALS = SpecialTokens(
    im_start=-1,
    im_end=-1,
    newline=-1,
    bos=128000,
    start_header=128006,
    end_header=128007,
    eot=128009,
)


def tokenizer_image_token(
    prompt: str,
    tokenizer: Tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    bos_token_id: Optional[int] = None,
) -> List[int]:
    """Tokenize text containing ``<image>`` markers, splicing
    ``image_token_index`` sentinels (handles a leading BOS emitted by every
    chunk)."""
    chunks = [tokenizer.encode(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    offset = 0
    ids: List[int] = []
    if chunks and chunks[0] and bos_token_id is not None and chunks[0][0] == bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i < len(chunks) - 1:
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])
    return ids


def _strip_prompt(text: str) -> str:
    """Q-Former conditioning text: user content without <image>/newlines
    (reference :711)."""
    return text.replace(DEFAULT_IMAGE_TOKEN, "").replace("\n", "")


def preprocess_qwen(
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer: Tokenizer,
    has_image: bool = False,
    system_message: str = "You are a helpful assistant.",
    specials: SpecialTokens = QWEN_SPECIALS,
) -> Dict[str, Any]:
    """ChatML tokenization with assistant-only labels.

    Mirrors preprocess_qwen (mm_datautils.py:645-736): system + per-turn
    ``<|im_start|>role\\ncontent<|im_end|>\\n`` blocks; user/system tokens are
    IGNORE_INDEX except structural tokens (im_start/im_end/newline); <image>
    becomes IMAGE_TOKEN_INDEX; plain user prompts are collected for the
    Q-Former.
    """
    roles = {"human": "user", "gpt": "assistant", "user": "user", "assistant": "assistant"}
    unmask = {specials.newline, specials.im_start, specials.im_end}

    all_ids, all_labels, prompts = [], [], []
    for source in sources:
        source = list(source)
        if source and roles.get(_role(source[0]), "user") != "user":
            source = source[1:]
        ids: List[int] = []
        labels: List[int] = []

        def add(text: str, is_target: bool):
            seg = (
                tokenizer_image_token(text, tokenizer, bos_token_id=specials.bos)
                if has_image and DEFAULT_IMAGE_TOKEN in text
                else tokenizer.encode(text)
            )
            ids.extend(seg)
            if is_target:
                labels.extend(seg)
            else:
                labels.extend(
                    t if t in unmask else IGNORE_INDEX for t in seg
                )

        add(f"<|im_start|>system\n{system_message}<|im_end|>\n", False)
        for turn in source:
            role = roles.get(_role(turn), _role(turn))
            content = _content(turn)
            target = role == "assistant"
            add(f"<|im_start|>{role}\n{content}<|im_end|>\n", target)
            if not target:
                prompts.append(_strip_prompt(content))
        all_ids.append(ids)
        all_labels.append(labels)
    return {"input_ids": all_ids, "labels": all_labels, "prompts": prompts}


def preprocess_llama3_2(
    sources: Sequence[Sequence[Dict[str, str]]],
    tokenizer: Tokenizer,
    has_image: bool = False,
    system_message: str = "You are a helpful assistant.",
    specials: SpecialTokens = LLAMA3_SPECIALS,
) -> Dict[str, Any]:
    """Llama-3 header-format tokenization with assistant-only labels
    (reference preprocess_llama_3_2, mm_datautils.py:956-1040)."""
    roles = {"human": "user", "gpt": "assistant", "user": "user", "assistant": "assistant"}
    unmask = {specials.bos, specials.start_header, specials.end_header, specials.eot}

    all_ids, all_labels, prompts = [], [], []
    for source in sources:
        source = list(source)
        if source and roles.get(_role(source[0]), "user") != "user":
            source = source[1:]
        ids: List[int] = [specials.bos]
        labels: List[int] = [specials.bos]

        def add(role: str, content: str, is_target: bool):
            text = f"<|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>"
            seg = (
                tokenizer_image_token(text, tokenizer, bos_token_id=specials.bos)
                if has_image and DEFAULT_IMAGE_TOKEN in text
                else tokenizer.encode(text)
            )
            # the conversation carries exactly one BOS (prepended above); HF
            # llama tokenizers re-add one per encode call — drop it (the
            # reference tokenizes the whole conversation once and strips
            # per-chunk BOS via its offset mechanism, mm_datautils.py:594-608)
            if specials.bos is not None and seg and seg[0] == specials.bos:
                seg = seg[1:]
            ids.extend(seg)
            if is_target:
                labels.extend(seg)
            else:
                labels.extend(t if t in unmask else IGNORE_INDEX for t in seg)

        add("system", system_message, False)
        for turn in source:
            role = roles.get(_role(turn), _role(turn))
            content = _content(turn)
            target = role == "assistant"
            add(role, content, target)
            if not target:
                prompts.append(_strip_prompt(content))
        all_ids.append(ids)
        all_labels.append(labels)
    return {"input_ids": all_ids, "labels": all_labels, "prompts": prompts}


def preprocess(
    sources,
    tokenizer: Tokenizer,
    conv_version: str = "qwen",
    has_image: bool = False,
) -> Dict[str, Any]:
    """Dispatcher (reference mm_datautils.py:1313-1350)."""
    if conv_version == "qwen":
        return preprocess_qwen(sources, tokenizer, has_image)
    if conv_version in ("llama3_2", "llama3"):
        return preprocess_llama3_2(sources, tokenizer, has_image)
    raise ValueError(f"unknown conversation version {conv_version}")


def _role(turn: Dict[str, str]) -> str:
    return turn.get("role", turn.get("from", "user"))


def _content(turn: Dict[str, str]) -> str:
    return turn.get("content", turn.get("value", ""))


# ---------------------------------------------------------------------------
# Fixed-shape packing (the collator, replacing prepare_multimodal_data,
# tdc/train.py:245-412 + DataCollator :715-814)
# ---------------------------------------------------------------------------


def pack_text(
    ids_list: Sequence[Sequence[int]],
    labels_list: Optional[Sequence[Sequence[int]]],
    max_len: int,
    pad_id: int,
    image_position: int = 91,
) -> Dict[str, np.ndarray]:
    """Right-pad token/label rows to max_len and locate the <image> sentinel.

    Rows with no image sentinel get one *logically* inserted at
    ``image_position`` (reference inserts a dummy image token at position 91
    for text-only rows so batch shapes match, tdc/train.py:794-814): here the
    row is left untouched and image_pos points at a position whose splice will
    receive n_visual=0 tokens.
    """
    B = len(ids_list)
    out_ids = np.full((B, max_len), pad_id, np.int32)
    out_labels = np.full((B, max_len), IGNORE_INDEX, np.int32)
    image_pos = np.zeros((B,), np.int32)
    text_len = np.zeros((B,), np.int32)
    has_image = np.zeros((B,), bool)
    pos_lists = []
    for b, ids in enumerate(ids_list):
        ids = list(ids)[:max_len]
        arr = np.asarray(ids, np.int64)
        img = np.nonzero(arr == IMAGE_TOKEN_INDEX)[0]
        pos_lists.append([int(i) for i in img])
        if len(img) > 0:
            has_image[b] = True
            image_pos[b] = int(img[0])
            arr = arr.copy()
            arr[img] = 0  # placeholder; embedding of the slot is overwritten by splice
        else:
            image_pos[b] = min(image_position, max(len(ids) - 1, 0))
        out_ids[b, : len(arr)] = arr
        text_len[b] = len(arr)
        if labels_list is not None:
            lab = list(labels_list[b])[:max_len]
            lab = [IGNORE_INDEX if t == IMAGE_TOKEN_INDEX else t for t in lab]
            out_labels[b, : len(lab)] = lab
    # every <image> position per row, -1 padded (reference splices at each,
    # tdc/cambrian_arch.py:1457-1734); consumed by splice_visual_multi
    M = max(1, max(len(p) for p in pos_lists))
    image_pos_multi = np.full((B, M), -1, np.int32)
    for b, p in enumerate(pos_lists):
        image_pos_multi[b, : len(p)] = p
    return {
        "input_ids": out_ids,
        "labels": out_labels if labels_list is not None else None,
        "image_pos": image_pos,
        "image_pos_multi": image_pos_multi,
        "text_len": text_len,
        "has_image": has_image,
    }
