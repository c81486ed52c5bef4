"""Small adapters shared by the train entry point (port of
tdc_video_tpu/train/runner_utils.py)."""

from __future__ import annotations


class _Protocol:
    def __init__(self, tok):
        self.tok = tok

    def encode(self, text):
        return self.tok(text).input_ids


def hf_tokenizer_protocol(tok):
    """HF tokenizer -> data-layer protocol (.encode -> List[int])."""
    if tok is None or hasattr(tok, "encode") and not hasattr(tok, "__call__"):
        return tok
    return _Protocol(tok)
