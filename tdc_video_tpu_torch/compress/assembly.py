"""Token assembly: splice compressed visual tokens into the text embeddings at
the <image> position (port of tdc_video_tpu/compress/assembly.py).
splice_visual_dynamic and splice_visual_multi take the batch written out
(JAX vmaps them); splice_visual is per sample, as in JAX."""

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


def splice_visual_multi(
    text_embeds: torch.Tensor,  # [B, L, H]
    image_pos: torch.Tensor,  # [B, M] <image> positions, ascending; -1 = unused slot
    visual: torch.Tensor,  # [B, M, V_max, H] per-image visual tokens
    n_visual: torch.Tensor,  # [B, M] valid tokens per image
    max_len: int,
    labels: Optional[torch.Tensor] = None,  # [B, L]
    text_len: Optional[torch.Tensor] = None,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Several <image> slots per sample.  Layout per row:

        text[:p0] | vis0 | text[p0+1:p1] | vis1 | text[p1+1:...] ...

    right-padded to max_len; unused slots (image_pos -1) splice nothing.
    Returns (embeds [B, max_len, H], attn_mask, labels or None, seq_len
    [B]).  Pure gathers."""
    B, L, H = text_embeds.shape
    M, V = visual.shape[1], visual.shape[2]
    dev = text_embeds.device
    tl = torch.full((B,), L, dtype=torch.int32, device=dev) if text_len is None else text_len.to(torch.int32)
    valid = image_pos >= 0  # [B, M]
    pos = torch.where(valid, image_pos.to(torch.int32), L)
    nv = torch.where(valid, n_visual.to(torch.int32), 0)
    # delta: tokens inserted less the <image> slot consumed
    delta = nv - valid.to(torch.int32)
    cum_before = torch.cumsum(delta, dim=-1) - delta
    vis_start = pos + cum_before  # [B, M] output offset of each visual block

    j = torch.arange(max_len, dtype=torch.int32, device=dev)[None, :, None]  # [1, max_len, 1]
    in_vis_m = (j >= vis_start[:, None]) & (j < (vis_start + nv)[:, None])  # [B, max_len, M]
    in_vis = in_vis_m.any(-1)
    which = torch.argmax(in_vis_m.to(torch.int32), dim=-1)  # the first True, as jnp.argmax
    rows = torch.arange(B, device=dev)[:, None]
    v_idx = (j[..., 0] - torch.take_along_dim(vis_start, which, dim=1)).clamp(0, V - 1).long()
    vis_src = visual[rows, which, v_idx]  # [B, max_len, H]

    # text index: undo the insertions of every block that ends at or before j
    passed = (j >= (vis_start + nv)[:, None]).to(torch.int32)  # [B, max_len, M]
    shift = (passed * delta[:, None]).sum(-1)
    t_idx = (j[..., 0] - shift).clamp(0, L - 1).long()
    out = torch.where(in_vis[..., None], vis_src, text_embeds[rows, t_idx])

    seq_len = torch.minimum(tl + delta.sum(-1), torch.full_like(tl, max_len))
    attn_mask = j[..., 0] < seq_len[:, None]
    out = torch.where(attn_mask[..., None], out, torch.zeros((), dtype=out.dtype, device=dev))

    out_labels = None
    if labels is not None:
        lab = torch.where(in_vis, IGNORE_INDEX, labels[rows, t_idx])
        out_labels = torch.where(attn_mask, lab, IGNORE_INDEX).to(torch.int32)
    return out, attn_mask, out_labels, seq_len


def splice_visual(
    text_embeds: torch.Tensor,  # [L, H] embeddings of input_ids (image token slot included)
    image_pos: int,  # index of the <image> token in input_ids
    visual: torch.Tensor,  # [V_max, H]
    n_visual,  # valid visual tokens (int or scalar tensor)
    max_len: int,
    labels: Optional[torch.Tensor] = None,  # [L]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """One sample with its <image> at a fixed position.  Returns (embeds
    [max_len, H], attn_mask [max_len], labels [max_len] or None, seq_len).
    Layout: text[:image_pos] | visual[:n_visual] | text[image_pos+1:],
    right-padded to max_len; visual positions get IGNORE_INDEX labels.
    Writes past max_len land in one discarded slot, as in JAX."""
    L, H = text_embeds.shape
    V = visual.shape[0]
    dev = text_embeds.device
    nv = torch.as_tensor(n_visual, device=dev).to(torch.int64)
    n_post = L - image_pos - 1

    out = torch.zeros((max_len + 1, H), dtype=text_embeds.dtype, device=dev)
    out[:image_pos] = text_embeds[:image_pos]
    ar = torch.arange(V, device=dev)
    vis_slot = image_pos + ar
    vis_slot = torch.where((ar < nv) & (vis_slot < max_len), vis_slot, max_len)
    out[vis_slot] = visual.to(out.dtype)
    post_slot = (image_pos + nv + torch.arange(n_post, device=dev)).clamp_max(max_len)
    out[post_slot] = text_embeds[image_pos + 1:]

    seq_len = torch.clamp_max(L - 1 + nv, max_len)
    attn_mask = torch.arange(max_len, device=dev) < seq_len

    out_labels = None
    if labels is not None:
        lab = torch.full((max_len + 1,), IGNORE_INDEX, dtype=torch.int32, device=dev)
        lab[:image_pos] = labels[:image_pos].to(torch.int32)
        lab[post_slot] = labels[image_pos + 1:].to(torch.int32)
        out_labels = lab[:max_len]
    return out[:max_len], attn_mask, out_labels, seq_len
