"""Token assembly: splice compressed visual tokens into the text embeddings at
the <image> position (port of splice_visual_dynamic from
tdc_video_tpu/compress/assembly.py, with the batch written out)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..constants import IGNORE_INDEX


def splice_visual_dynamic(
    text_embeds: torch.Tensor,  # [B, L, H] embeddings of input_ids (incl. <image> slot)
    image_pos: torch.Tensor,  # [B] position of the <image> token
    visual: torch.Tensor,  # [B, V_max, H]
    n_visual: torch.Tensor,  # [B]
    max_len: int,
    labels: Optional[torch.Tensor] = None,  # [B, L]
    text_len: Optional[torch.Tensor] = None,  # [B] valid text length
    has_image: Optional[torch.Tensor] = None,  # [B] bool; False = text-only row
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Layout per row: text[:image_pos] | visual[:n_visual] |
    text[image_pos+1:text_len], right-padded to max_len.  Returns
    (embeds [B, max_len, H], attn_mask [B, max_len], labels or None,
    seq_len [B]).  Pure gathers."""
    B, L, H = text_embeds.shape
    V = visual.shape[1]
    dev = text_embeds.device
    tl = torch.full((B,), L, dtype=torch.int32, device=dev) if text_len is None else text_len.to(torch.int32)
    hi = torch.ones((B,), dtype=torch.bool, device=dev) if has_image is None else has_image
    skip = hi.to(torch.int32)  # the <image> slot itself
    nv = torch.where(hi, n_visual.to(torch.int32), 0)
    nv = torch.minimum(nv, max_len - (tl - skip))

    j = torch.arange(max_len, dtype=torch.int32, device=dev)[None]  # [1, max_len]
    ip = image_pos.to(torch.int32)[:, None]
    nv_, skip_ = nv[:, None], skip[:, None]
    in_pre = j < ip
    in_vis = (j >= ip) & (j < ip + nv_)
    t_idx = torch.where(in_pre, j, j - nv_ + skip_).clamp(0, L - 1).long()
    v_idx = (j - ip).clamp(0, V - 1).long()

    rows = torch.arange(B, device=dev)[:, None]
    out = torch.where(in_vis[..., None], visual[rows, v_idx], text_embeds[rows, t_idx])
    seq_len = torch.minimum(tl - skip + nv, torch.full_like(tl, max_len))
    attn_mask = j < seq_len[:, None]
    out = torch.where(attn_mask[..., None], out, torch.zeros((), dtype=out.dtype, device=dev))

    out_labels = None
    if labels is not None:
        lab = torch.where(in_vis, IGNORE_INDEX, labels[rows, t_idx])
        out_labels = torch.where(attn_mask, lab, IGNORE_INDEX).to(torch.int32)
    return out, attn_mask, out_labels, seq_len
