"""Token-budget bookkeeping, host-side (port of tdc_video_tpu/compress/budget.py)."""

from __future__ import annotations

from typing import Sequence

from ..config import TDCConfig
from ..constants import AUDIO_TOKENS_PER_SECOND


def text_length(cfg: TDCConfig, input_ids: Sequence[int]) -> int:
    """Length up to the first pad/eot token."""
    pad = cfg.lm.pad_token_id
    for i, t in enumerate(input_ids):
        if t == pad:
            return i
    return len(input_ids)


def tokens_per_frame(cfg: TDCConfig) -> int:
    c = cfg.compression
    if not c.add_static:
        return c.context_token_num
    static = cfg.sva.image_token_len + (AUDIO_TOKENS_PER_SECOND if cfg.audio_input else 0)
    return (static + c.context_token_num * (c.chunk_size - 1)) // c.chunk_size


def max_num_frames(cfg: TDCConfig, input_ids: Sequence[int], train: bool = True) -> int:
    """Frame cap from the token budget, clamped by the train/eval caps."""
    tlen = text_length(cfg, input_ids)
    budget = cfg.tokenizer_model_max_length - tlen - cfg.inference_max_length
    cap = cfg.compression.max_train_frames if train else cfg.compression.max_eval_frames
    return max(1, min(budget // tokens_per_frame(cfg), cap))


def max_visual_len(cfg: TDCConfig, input_ids: Sequence[int]) -> int:
    """Hard cap on spliced visual tokens."""
    tlen = text_length(cfg, input_ids)
    return max(1, cfg.tokenizer_model_max_length - cfg.inference_max_length - tlen)
