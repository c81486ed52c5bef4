"""Scene segmentation: cosine similarity of adjacent DINO features + the
lowest-similarity boundaries, and the uniform frame resample (port of
tdc_video_tpu/ops/segment.py)."""

from __future__ import annotations

import torch

from ..utils.profiling import span


def adjacent_cosine_similarity(feats: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
    """feats [T, ...] (flattened per frame), mask [T] -> sims [T-1] f32.
    Invalid pairs get +2.0 (never selected as cuts)."""
    T = feats.shape[0]
    flat = feats.reshape(T, -1).float()
    norm = torch.sqrt(torch.sum(flat * flat, dim=-1) + 1e-12)
    dots = torch.sum(flat[:-1] * flat[1:], dim=-1)
    sims = dots / (norm[:-1] * norm[1:])
    valid_pair = frame_mask[:-1] & frame_mask[1:]
    return torch.where(valid_pair, sims, torch.full_like(sims, 2.0))


def segment_boundaries(
    dino_feats: torch.Tensor,  # [T, tokens, C] (or any [T, ...])
    frame_mask: torch.Tensor,  # [T] bool
    max_num_segments: int,
) -> torch.Tensor:
    """Returns boundary [T] bool: True where a new segment starts."""
    with span("compress.segment", device=True, frames=dino_feats.shape[0]) as sp:
        T = dino_feats.shape[0]
        n_valid = frame_mask.sum()
        sims = adjacent_cosine_similarity(dino_feats, frame_mask)
        k = min(max_num_segments, T - 1) if T > 1 else 0
        long_boundary = torch.zeros((T,), dtype=torch.bool, device=dino_feats.device)
        if k > 0:
            # lax.top_k(-sims, k) returns equal values lowest index first; a
            # stable descending sort keeps that order (torch.topk does not promise it)
            cut_idx = torch.sort(-sims, descending=True, stable=True).indices[:k]
            long_boundary[cut_idx + 1] = True
        long_boundary = long_boundary & frame_mask
        long_boundary[0] = frame_mask[0]
        short = n_valid <= max_num_segments + 1
        boundary = torch.where(short, frame_mask, long_boundary)
        if sp:
            sp.set(segments=boundary.sum())
        return boundary



def uniform_sample_indices(n_frames: int, max_frames: int):
    """Reference uniform resample (cambrian_arch.py:910-912): floor(interval*i).
    Host-side helper: returns a python list."""
    if n_frames <= max_frames:
        return list(range(n_frames))
    interval = n_frames / float(max_frames)
    return [int(interval * i) for i in range(max_frames)]
