"""Top-level TDC-Video model: towers -> SVA -> segment -> TDC -> LM (port of
tdc_video_tpu/model.py, visual-only inference path).

    encode_frames                     towers + SVA + newline        [T, P, H]
    prepare_visual                    segmentation + TDC compression [Vmax, H]
    prepare_multimodal_from_features  compression + splice           [B, Lmax, H]
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .compress.assembly import splice_visual_dynamic
from .compress.tdc import compress_video, init_compressor
from .config import TDCConfig
from .device import resolve_device
from .models import lm as lm_mod
from .models.layers import normal_init
from .models.sva import init_sva, sva_forward
from .models.vit import init_vit, vit_forward
from .ops.pooling import adaptive_pool_matrix
from .ops.segment import segment_boundaries

Params = Any


def init_tdc(cfg: TDCConfig, generator: torch.Generator, device=None, dtype=None) -> Params:
    """Random parameter tree with the JAX initializers' distributions (not
    their bits).  dtype defaults to cfg.param_dtype; storing bf16 directly
    changes no rounding, since `linear` casts weights to the activation
    dtype before the dot."""
    device = resolve_device(device)
    dt = cfg.param_dtype if dtype is None else dtype
    g = generator
    return {
        "siglip": init_vit(cfg.siglip, g, device, dt),
        "dino": init_vit(cfg.dino, g, device, dt),
        "sva": init_sva(cfg.sva, (cfg.siglip.hidden_size, cfg.dino.hidden_size),
                        cfg.lm.hidden_size, g, device, dt),
        "compressor": init_compressor(cfg, g, device, dt),
        "lm": lm_mod.init_lm(cfg.lm, g, device, dt),
        "image_newline": normal_init(g, (cfg.lm.hidden_size,), dt, device),
    }


def frame_token_len(cfg: TDCConfig) -> int:
    """Tokens per encoded frame: the SVA grid plus one newline per row."""
    side = cfg.sva.final_side_len
    if cfg.compression.is_image_newline:
        return cfg.sva.image_token_len + side
    return cfg.sva.image_token_len


def encode_frames(
    cfg: TDCConfig,
    params: Params,
    siglip_px: torch.Tensor,  # [T, Hs, Ws, 3] normalized
    dino_px: torch.Tensor,  # [T, Hd, Wd, 3] normalized
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (frame_feats [T, P, H_lm], dino_feats [T, 576, C_dino])."""
    dt = cfg.dtype
    dino_feats = vit_forward(cfg.dino, params["dino"], dino_px, attn_impl=attn_impl, dtype=dt)
    siglip_feats = vit_forward(cfg.siglip, params["siglip"], siglip_px, attn_impl=attn_impl, dtype=dt)
    feats = sva_forward(cfg.sva, params["sva"], [siglip_feats, dino_feats])  # [T, 144, H]
    T, _, H = feats.shape
    side = cfg.sva.final_side_len
    if cfg.compression.is_image_newline:
        grid = feats.reshape(T, side, side, H)
        nl = params["image_newline"].to(grid.dtype)[None, None, None].expand(T, side, 1, H)
        feats = torch.cat([grid, nl], dim=2).reshape(T, side * (side + 1), H)
    return feats, dino_feats


def prepare_visual(
    cfg: TDCConfig,
    params: Params,
    frame_feats: torch.Tensor,  # [T, P, H]
    dino_feats: torch.Tensor,  # [T, 576, C]
    frame_mask: torch.Tensor,  # [T] bool
    qformer_text_ids: Optional[torch.Tensor],  # [Lq]
    qformer_text_mask: Optional[torch.Tensor],  # [Lq]
    max_visual_len: int = 4096,
    token_valid: Optional[torch.Tensor] = None,  # [P]
    query_pool: Optional[torch.Tensor] = None,  # [K, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmentation + TDC compression for ONE video: (visual [Vmax, H], n_visual)."""
    boundary = segment_boundaries(dino_feats, frame_mask, cfg.compression.max_num_segments)
    return compress_video(
        cfg, params["compressor"], frame_feats, frame_mask, boundary, qformer_text_ids,
        qformer_text_mask, max_visual_len=max_visual_len, dtype=cfg.compress_dtype,
        token_valid=token_valid, query_pool=query_pool,
    )


def prepare_multimodal_from_features(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, L]
    image_pos: torch.Tensor,  # [B]
    frame_feats: torch.Tensor,  # [B, T, P, H]
    dino_feats: torch.Tensor,  # [B, T, Nd, Cd]
    frame_mask: torch.Tensor,  # [B, T]
    qformer_text_ids: Optional[torch.Tensor],  # [B, Lq]
    qformer_text_mask: Optional[torch.Tensor],
    text_len: Optional[torch.Tensor] = None,  # [B]
    token_valid: Optional[torch.Tensor] = None,  # [B, P]
    query_pool: Optional[torch.Tensor] = None,  # [B, K, P]
    max_len: int = 4096,
    max_visual_len: int = 2048,
) -> Dict[str, torch.Tensor]:
    """Compression + splice over pre-encoded frames.  JAX vmaps over the
    batch; here compression loops over the samples (each has its own
    segments and chunks) and the splice runs batched."""
    B, T = frame_mask.shape
    P = frame_feats.shape[2]
    dev = frame_feats.device
    if token_valid is None:
        token_valid = torch.ones((B, P), dtype=torch.bool, device=dev)
    if query_pool is None:
        K = cfg.compression.context_token_num
        query_pool = torch.from_numpy(adaptive_pool_matrix(P, K)).to(dev)[None].expand(B, K, P)

    vis, nvis = [], []
    for b in range(B):
        v, nv = prepare_visual(
            cfg, params, frame_feats[b], dino_feats[b], frame_mask[b],
            None if qformer_text_ids is None else qformer_text_ids[b],
            None if qformer_text_mask is None else qformer_text_mask[b],
            max_visual_len=max_visual_len, token_valid=token_valid[b], query_pool=query_pool[b],
        )
        vis.append(v)
        nvis.append(nv)
    text_embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], input_ids, cfg.dtype)
    visual = torch.stack(vis).to(text_embeds.dtype)
    if text_len is None:
        text_len = torch.full((B,), input_ids.shape[1], dtype=torch.int32, device=dev)
    embeds, attn_mask, _, seq_len = splice_visual_dynamic(
        text_embeds, image_pos, visual, torch.stack(nvis), max_len, text_len=text_len
    )
    return {"embeds": embeds, "attn_mask": attn_mask, "labels": None, "seq_len": seq_len}
