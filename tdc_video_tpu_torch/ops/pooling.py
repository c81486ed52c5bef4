"""Adaptive average pooling as a matmul (port of tdc_video_tpu/ops/pooling.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights replicating torch adaptive_avg_pool1d: output i
    averages input[floor(i*n/k) : ceil((i+1)*n/k)]."""
    w = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-((i + 1) * n_in) // n_out)  # ceil
        w[i, start:end] = 1.0 / (end - start)
    return w


def adaptive_avg_pool_tokens(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """Pool the second-to-last axis: [..., N, C] -> [..., n_out, C]."""
    w = torch.from_numpy(adaptive_pool_matrix(x.shape[-2], n_out)).to(x.device, x.dtype)
    return torch.einsum("kn,...nc->...kc", w, x)
