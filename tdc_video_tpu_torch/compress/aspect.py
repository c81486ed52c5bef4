"""Aspect-ratio token layout, the static-shape form of unpad_image (port of
tdc_video_tpu/compress/aspect.py).  Shapes stay fixed at P = side*(side+1);
the aspect is carried by a [P] token-validity mask and a [K, P] pooling
matrix over the compacted valid sequence, both computed on the host."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..config import TDCConfig


@functools.lru_cache(maxsize=256)
def _layout(side: int, newline: bool, orig_h: int, orig_w: int, K: int):
    """Returns (token_valid [P] bool, query_pool [K, P] f32)."""
    cols = side + (1 if newline else 0)
    P = side * cols
    if orig_w > orig_h:  # landscape: rows were padded
        new_h = int(orig_h * side / orig_w) if orig_h != orig_w else side
        pad = (side - new_h) // 2
        r0, r1, c0, c1 = pad, side - pad, 0, side
    elif orig_h > orig_w:  # portrait: cols were padded
        new_w = int(orig_w * side / orig_h)
        pad = (side - new_w) // 2
        r0, r1, c0, c1 = 0, side, pad, side - pad
    else:
        r0, r1, c0, c1 = 0, side, 0, side

    valid = np.zeros((side, cols), bool)
    valid[r0:r1, c0:c1] = True
    if newline:
        valid[r0:r1, side] = True  # one newline token per kept row
    flat_valid = valid.reshape(P)

    idx = np.nonzero(flat_valid)[0]
    n = len(idx)
    pool = np.zeros((K, P), np.float32)
    for i in range(K):
        a = (i * n) // K
        b = -(-((i + 1) * n) // K)
        pool[i, idx[a:b]] = 1.0 / (b - a)
    return flat_valid, pool


def frame_token_layout(cfg: TDCConfig, orig_h: int, orig_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side per-video layout: (token_valid [P], query_pool [K, P])."""
    return _layout(
        cfg.sva.final_side_len,
        cfg.compression.is_image_newline,
        int(orig_h),
        int(orig_w),
        cfg.compression.context_token_num,
    )


def square_layout(cfg: TDCConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The layout of a square frame (and of a sample without frames)."""
    return frame_token_layout(cfg, 1, 1)
