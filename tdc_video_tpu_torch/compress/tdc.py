"""Temporal Dynamic Context compression (port of tdc_video_tpu/compress/tdc.py).

As in JAX: chunk assignment with cumulative ops over the frame axis, frames
(with their A audio tokens after the P visual ones, when there is audio)
scattered into a [MAX_CHUNKS+1, chunk_size, P+A, H] buffer (row MAX_CHUNKS is
a trash row for padded frames), one batched Q-Former call over every
(chunk, subsequent frame) pair, then masked emission, the global budget
clamp and a gather compaction.  `lax.associative_scan(max)` is torch.cummax.

Under autograd the frame scatter (index_put into a zero buffer) and the final
gather carry gradients to the frame features, as JAX's scatter and gather
do; a padded frame's slot in the trash row gets the trash row's (unused)
gradient in both.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

from ..config import TDCConfig
from ..device import resolve_device
from ..models.layers import init_linear, linear, normal_init
from ..models.qformer import init_qformer, qformer_forward
from ..ops.pooling import adaptive_avg_pool_tokens

Params = Any


def init_compressor(cfg: TDCConfig, gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    """Q-Former + query_proj (H->768) + vision_proj (768->H) + learned query
    tokens + frame separator embedding."""
    device = resolve_device(device)
    q = cfg.qformer
    H = cfg.lm.hidden_size
    return {
        "qformer": init_qformer(q, gen, device, dtype),
        "query_proj": init_linear(gen, H, q.hidden_size, dtype, device),
        "vision_proj": init_linear(gen, q.hidden_size, H, dtype, device),
        "query_tokens": normal_init(gen, (cfg.compression.context_token_num, q.hidden_size), dtype, device),
        "frame_seg": normal_init(gen, (H,), dtype, device, stddev=1.0),
    }


def max_chunks(cfg: TDCConfig, t_max: int) -> int:
    """Worst-case chunk count: T/chunk + max_num_segments (+1)."""
    c = cfg.compression
    return math.ceil(t_max / c.chunk_size) + c.max_num_segments + 1


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def assign_chunks(
    boundary: torch.Tensor,  # [T] bool segment starts
    frame_mask: torch.Tensor,  # [T] bool
    chunk_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (chunk_id [T], pos_in_chunk [T], num_chunks scalar).  Chunks
    restart at every segment boundary and every `chunk_size` frames."""
    T = boundary.shape[0]
    t = torch.arange(T, device=boundary.device)
    b = boundary & frame_mask
    b[0] = frame_mask[0]
    seg_start = _cummax(torch.where(b, t, -1))
    pos_in_seg = t - seg_start
    chunk_start = (b | (pos_in_seg % chunk_size == 0)) & frame_mask
    chunk_id = torch.cumsum(chunk_start.to(torch.int64), 0) - 1
    chunk_anchor = _cummax(torch.where(chunk_start, t, -1))
    pos_in_chunk = t - chunk_anchor
    num_chunks = torch.where(frame_mask, chunk_id, -1).max() + 1
    return chunk_id, pos_in_chunk, num_chunks


def compress_video(
    cfg: TDCConfig,
    params: Params,  # {"qformer", "query_proj", "vision_proj", "query_tokens", "frame_seg"}
    frame_feats: torch.Tensor,  # [T, P, H] per-frame LLM-space tokens
    frame_mask: torch.Tensor,  # [T] bool
    boundary: torch.Tensor,  # [T] bool segment starts
    text_ids: Optional[torch.Tensor],  # [L] Q-Former prompt conditioning
    text_mask: Optional[torch.Tensor],  # [L] bool
    audio_feats: Optional[torch.Tensor] = None,  # [T, A, H] (already audio_proj'ed)
    max_visual_len: int = 4096,
    dtype=torch.float32,
    token_valid: Optional[torch.Tensor] = None,  # [P] bool aspect mask
    query_pool: Optional[torch.Tensor] = None,  # [K, P] masked pooling matrix
    remat: bool = False,  # training: per-layer Q-Former checkpointing
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (visual [max_visual_len, H], n_visual scalar int32).  Audio
    tokens ride in each frame after its P visual tokens: they reach the
    Q-Former's encoder and each chunk's static block (P + A tokens), but
    not the pooled query, which is built from the visual tokens alone."""
    c = cfg.compression
    T, P, H = frame_feats.shape
    n = c.chunk_size
    K = c.context_token_num
    A = 0 if audio_feats is None else audio_feats.shape[1]
    MC = max_chunks(cfg, T)
    dev = frame_feats.device
    if token_valid is None:
        token_valid = torch.ones((P,), dtype=torch.bool, device=dev)
    if A:
        token_valid = torch.cat([token_valid, torch.ones((A,), dtype=torch.bool, device=dev)])
    tokens = frame_feats
    if audio_feats is not None:
        tokens = torch.cat([frame_feats, audio_feats.to(frame_feats.dtype)], dim=1)
    chunk_id, pos_in_chunk, num_chunks = assign_chunks(boundary, frame_mask, n)

    if c.add_static and T == 1:
        # single image: the lone frame is chunk 0's static block and the
        # Q-Former output never reaches the emission, so it is skipped
        n_comp = n - 1
        key_block = torch.zeros((MC + 1, P + A, H), dtype=tokens.dtype, device=dev)
        key_block[0] = tokens[0]
        chunk_valid = torch.zeros((MC + 1,), dtype=torch.bool, device=dev)
        chunk_valid[0] = frame_mask[0]
        others_valid = torch.zeros((MC + 1, n_comp), dtype=torch.bool, device=dev)
        comp = torch.zeros((MC + 1, n_comp, K, H), dtype=tokens.dtype, device=dev)
    else:
        # Scatter frames into chunk slots; padded frames land in trash row
        # MC (at slot 0: JAX drops their out-of-range slots, and the trash
        # row never reaches the output either way).
        row = torch.where(frame_mask, chunk_id, MC)
        pos = torch.where(frame_mask, pos_in_chunk, 0)
        chunk_feats = torch.zeros((MC + 1, n, P + A, H), dtype=tokens.dtype, device=dev)
        chunk_feats[row, pos] = tokens
        chunk_frame_valid = torch.zeros((MC + 1, n), dtype=torch.bool, device=dev)
        chunk_frame_valid[row, pos] = frame_mask
        chunk_valid = chunk_frame_valid[:, 0]  # a chunk exists iff slot 0 is filled

        key_block = chunk_feats[:, 0]  # [MC+1, P+A, H] static frame, audio included
        key_visual = key_block[:, :P]  # the pooled query sees the visual tokens only
        if c.add_static:
            others, others_valid, n_comp = chunk_feats[:, 1:], chunk_frame_valid[:, 1:], n - 1
        else:
            others, others_valid, n_comp = chunk_feats, chunk_frame_valid, n

        if c.query_type == "Avg_pool":
            if query_pool is None:
                pooled = adaptive_avg_pool_tokens(key_visual, K)  # [MC+1, K, H]
            else:
                pooled = torch.einsum("kp,mpc->mkc", query_pool.float(),
                                      key_visual.float()).to(key_visual.dtype)
            query = linear(params["query_proj"], pooled)  # [MC+1, K, 768]
        else:
            qt = params["query_tokens"].to(dtype)
            query = qt[None].expand(MC + 1, K, qt.shape[-1])
        query = query[:, None].expand(MC + 1, n_comp, K, query.shape[-1])

        # one batched Q-Former pass over all (chunk, frame) pairs
        B = (MC + 1) * n_comp
        enc = others.reshape(B, P + A, H)
        enc_mask = (others_valid[..., None] & token_valid[None, None]).reshape(B, P + A)
        q_flat = query.reshape(B, K, -1)
        if c.text_input and text_ids is not None:
            ids_b = text_ids[None].expand(B, text_ids.shape[0])
            tmask_b = text_mask[None].expand(B, text_mask.shape[0])
        else:
            ids_b = tmask_b = None
        out = qformer_forward(cfg.qformer, params["qformer"], q_flat, ids_b, tmask_b, enc,
                              enc_mask, dtype=dtype, remat=remat)  # [B, K, 768]
        comp = linear(params["vision_proj"], out)  # [B, K, H]
        norm = torch.sqrt(torch.sum(comp.float() ** 2, -1, keepdim=True) + 1e-12)
        comp = comp / norm.to(comp.dtype)
        comp = comp.reshape(MC + 1, n_comp, K, H).to(tokens.dtype)

    # --- Emission ---
    sep = params["frame_seg"].to(tokens.dtype)
    pieces, pieces_valid = [], []
    if c.add_static:
        kb = key_block
        kb_valid = chunk_valid[:, None] & token_valid[None]
        if c.add_sep:
            kb = torch.cat([kb, sep[None, None].expand(MC + 1, 1, H)], dim=1)
            kb_valid = torch.cat([kb_valid, chunk_valid[:, None]], dim=1)
        pieces.append(kb)
        pieces_valid.append(kb_valid)
    ob = comp  # [MC+1, n_comp, K, H]
    ob_valid = others_valid[..., None].expand(MC + 1, n_comp, K)
    if c.add_sep:
        ob = torch.cat([ob, sep[None, None, None].expand(MC + 1, n_comp, 1, H)], dim=2)
        ob_valid = torch.cat([ob_valid, others_valid[..., None]], dim=2)
    pieces.append(ob.reshape(MC + 1, -1, H))
    pieces_valid.append(ob_valid.reshape(MC + 1, -1))

    chunk_out = torch.cat(pieces, dim=1)  # [MC+1, E, H]
    chunk_out_valid = torch.cat(pieces_valid, dim=1)  # [MC+1, E]
    chunk_out_valid = chunk_out_valid & (torch.arange(MC + 1, device=dev) <= MC - 1)[:, None]

    # --- Global budget clamp ---
    total = chunk_out_valid.sum()
    excess = torch.clamp(total - max_visual_len, min=0)
    force_remove = torch.where(
        excess > 0, -torch.div(-excess, torch.clamp(num_chunks, min=1), rounding_mode="floor"), 0
    )  # ceil div
    # rank from the end among valid tokens within each chunk
    rev_rank = torch.flip(torch.cumsum(torch.flip(chunk_out_valid, [1]).to(torch.int64), 1), [1])
    keep = chunk_out_valid & (rev_rank > force_remove)

    # --- Compaction: scatter source indices, then gather the rows ---
    flat = chunk_out.reshape(-1, H)
    flat_keep = keep.reshape(-1)
    target = torch.cumsum(flat_keep.to(torch.int64), 0) - 1
    slot = torch.where(flat_keep & (target < max_visual_len), target, max_visual_len)
    src = torch.zeros((max_visual_len + 1,), dtype=torch.int64, device=dev)
    src[slot] = torch.arange(flat.shape[0], device=dev)
    visual = flat[src[:max_visual_len]]
    n_visual = torch.clamp(flat_keep.sum(), max=max_visual_len).to(torch.int32)
    return visual, n_visual
