"""Tokenization of prompts with <image> markers (port of tokenizer_image_token
from tdc_video_tpu/data/preprocess.py).  The tokenizer is anything with
`encode(text) -> List[int]`."""

from __future__ import annotations

from typing import List, Optional, Protocol

from ..constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...


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
