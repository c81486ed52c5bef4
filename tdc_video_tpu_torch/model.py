"""Top-level TDC-Video model: towers -> SVA -> segment -> TDC -> LM (port of
tdc_video_tpu/model.py; frame_pos is not ported).

    encode_frames                     towers + SVA + newline        [T, P, H]
    encode_audio                      fbank + BEATs + frame pooling  [T, 50, H]
    prepare_visual                    segmentation + TDC compression [Vmax, H]
    prepare_multimodal_inputs         encode + compress + splice     [B, Lmax, H]
    prepare_multimodal_from_features  compression + splice           [B, Lmax, H]
    prepare_multimodal_multi_image    images (no compression) + splice [B, Lmax, H]
    tdc_loss                          all of the above + LM CE       scalar

Training remat (JAX's jax.checkpoint) is torch.utils.checkpoint without
reentrancy: the SVA in chunks of 16 frames, the per-sample segment+compress
stage, each Q-Former layer and each LM layer, and (for raw audio) each
sample's audio encode.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .compress.assembly import splice_visual_dynamic
from .compress.tdc import compress_video, init_compressor
from .config import TDCConfig
from .device import resolve_device
from .models import lm as lm_mod
from .models.beats import beats_forward, init_beats
from .models.layers import init_linear, linear, normal_init
from .models.sva import init_sva, sva_forward
from .models.vit import init_vit, vit_forward
from .ops.audio import kaldi_fbank, pool_seconds_to_frames, window_to_seconds
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
    params = {
        "siglip": init_vit(cfg.siglip, g, device, dt),
        "dino": init_vit(cfg.dino, g, device, dt),
        "sva": init_sva(cfg.sva, (cfg.siglip.hidden_size, cfg.dino.hidden_size),
                        cfg.lm.hidden_size, g, device, dt),
        "compressor": init_compressor(cfg, g, device, dt),
        "lm": lm_mod.init_lm(cfg.lm, g, device, dt),
        "image_newline": normal_init(g, (cfg.lm.hidden_size,), dt, device),
    }
    if cfg.audio_input:
        params["beats"] = init_beats(cfg.beats, g, device, dt)
        params["audio_proj"] = init_linear(g, cfg.beats.encoder_embed_dim, cfg.lm.hidden_size,
                                           dt, device)
    return params


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
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (frame_feats [T, P, H_lm], dino_feats [T, 576, C_dino]).
    remat=True (training) runs the SVA in checkpointed chunks of 16 frames,
    so the backward keeps one chunk's SVA internals at a time (JAX
    :132-155).  The towers get no checkpoint, as in JAX: frozen, they build
    no graph at all (their inputs are data)."""
    dt = cfg.dtype
    dino_feats = vit_forward(cfg.dino, params["dino"], dino_px, attn_impl=attn_impl, dtype=dt)
    siglip_feats = vit_forward(cfg.siglip, params["siglip"], siglip_px, attn_impl=attn_impl, dtype=dt)
    if remat:
        CH = 16
        Tt = siglip_feats.shape[0]
        pad = (-Tt) % CH
        sig_p = torch.nn.functional.pad(siglip_feats, (0, 0, 0, 0, 0, pad))
        dino_p = torch.nn.functional.pad(dino_feats, (0, 0, 0, 0, 0, pad))
        chunks = [
            checkpoint(lambda a, b: sva_forward(cfg.sva, params["sva"], [a, b]),
                       sig_p[c:c + CH], dino_p[c:c + CH], use_reentrant=False)
            for c in range(0, Tt + pad, CH)
        ]
        feats = torch.cat(chunks)[:Tt]  # [T, 144, H]
    else:
        feats = sva_forward(cfg.sva, params["sva"], [siglip_feats, dino_feats])  # [T, 144, H]
    T, _, H = feats.shape
    side = cfg.sva.final_side_len
    if cfg.compression.is_image_newline:
        grid = feats.reshape(T, side, side, H)
        nl = params["image_newline"].to(grid.dtype)[None, None, None].expand(T, side, 1, H)
        feats = torch.cat([grid, nl], dim=2).reshape(T, side * (side + 1), H)
    return feats, dino_feats


def encode_audio(
    cfg: TDCConfig,
    params: Params,
    wav_windows: torch.Tensor,  # [W, 160000] 10-s windows of 16 kHz audio
    wav_mask: torch.Tensor,  # [W, 160000] bool
    frame_of_sec: torch.Tensor,  # [S = W * 10] (ops.audio.second_groups)
    group_pos: torch.Tensor,  # [S]
    group_size: torch.Tensor,  # [T]
    num_frames: int,
    sec_valid: Optional[torch.Tensor] = None,  # [S] bool
) -> torch.Tensor:
    """Per-frame audio tokens [num_frames, 50, H_lm], already through
    audio_proj (JAX :179-203): fbank (f32), BEATs in cfg.dtype, per-second
    slicing, pooling of each frame's group of seconds."""
    fb = kaldi_fbank(wav_windows)
    fb_mask = wav_mask[:, ::160][:, : fb.shape[1]]
    tokens, _ = beats_forward(cfg.beats, params["beats"], fb, fb_mask, dtype=cfg.dtype)
    per_sec = window_to_seconds(tokens)  # [W, 10, 50, C]
    per_sec = per_sec.reshape((-1,) + per_sec.shape[2:])
    frame_audio = pool_seconds_to_frames(per_sec, frame_of_sec, group_pos, group_size, num_frames,
                                         sec_valid)
    return linear(params["audio_proj"], frame_audio.to(cfg.dtype))


def prepare_visual(
    cfg: TDCConfig,
    params: Params,
    frame_feats: torch.Tensor,  # [T, P, H]
    dino_feats: torch.Tensor,  # [T, 576, C]
    frame_mask: torch.Tensor,  # [T] bool
    qformer_text_ids: Optional[torch.Tensor],  # [Lq]
    qformer_text_mask: Optional[torch.Tensor],  # [Lq]
    audio_tokens: Optional[torch.Tensor] = None,  # [T, 50, H]
    max_visual_len: int = 4096,
    token_valid: Optional[torch.Tensor] = None,  # [P]
    query_pool: Optional[torch.Tensor] = None,  # [K, P]
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmentation + TDC compression for ONE video: (visual [Vmax, H], n_visual)."""
    boundary = segment_boundaries(dino_feats, frame_mask, cfg.compression.max_num_segments)
    return compress_video(
        cfg, params["compressor"], frame_feats, frame_mask, boundary, qformer_text_ids,
        qformer_text_mask, audio_feats=audio_tokens, max_visual_len=max_visual_len,
        dtype=cfg.compress_dtype, token_valid=token_valid, query_pool=query_pool, remat=remat,
    )


def prepare_multimodal_inputs(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, L]; <image> slot already a placeholder id
    image_pos: torch.Tensor,  # [B]
    siglip_px: torch.Tensor,  # [B, T, Hs, Ws, 3]
    dino_px: torch.Tensor,  # [B, T, Hd, Wd, 3]
    frame_mask: torch.Tensor,  # [B, T]
    qformer_text_ids: Optional[torch.Tensor],  # [B, Lq]
    qformer_text_mask: Optional[torch.Tensor],  # [B, Lq]
    audio_tokens: Optional[torch.Tensor] = None,  # [B, T, 50, H] precomputed
    audio_windows: Optional[torch.Tensor] = None,  # [B, W, 160000] raw 10-s wav
    audio_wmask: Optional[torch.Tensor] = None,  # [B, W, 160000]
    audio_frame_of_sec: Optional[torch.Tensor] = None,  # [B, S]
    audio_group_pos: Optional[torch.Tensor] = None,  # [B, S]
    audio_group_size: Optional[torch.Tensor] = None,  # [B, T]
    audio_sec_valid: Optional[torch.Tensor] = None,  # [B, S]
    labels: Optional[torch.Tensor] = None,  # [B, L]
    text_len: Optional[torch.Tensor] = None,  # [B]
    has_image: Optional[torch.Tensor] = None,  # [B] bool
    token_valid: Optional[torch.Tensor] = None,  # [B, P]
    query_pool: Optional[torch.Tensor] = None,  # [B, K, P]
    max_len: int = 4096,
    max_visual_len: int = 2048,
    attn_impl: str = "xla",
    remat_encode: bool = False,
) -> Dict[str, torch.Tensor]:
    """Encode every frame of the batch as one tower batch, then compress and
    splice (JAX :250-341): dict(embeds [B, max_len, H], attn_mask, labels,
    seq_len).  Raw audio windows are encoded per sample in the graph, so
    that gradients reach BEATs and audio_proj when they train; each
    sample's encode is checkpointed under remat_encode."""
    if cfg.compression.frame_pos:
        raise NotImplementedError("frame_pos (get_frame_pos) is not ported")
    B, T = frame_mask.shape
    if audio_tokens is None and audio_windows is not None:
        def enc(w, wm, f, p_, g, sv):
            return encode_audio(cfg, params, w, wm, f, p_, g, T, sv)

        per_sample = []
        for b in range(B):
            args = (audio_windows[b], audio_wmask[b], audio_frame_of_sec[b], audio_group_pos[b],
                    audio_group_size[b],
                    None if audio_sec_valid is None else audio_sec_valid[b])
            per_sample.append(checkpoint(enc, *args, use_reentrant=False) if remat_encode
                              else enc(*args))
        audio_tokens = torch.stack(per_sample)
    flat_sig = siglip_px.reshape((B * T,) + siglip_px.shape[2:])
    flat_dino = dino_px.reshape((B * T,) + dino_px.shape[2:])
    frame_feats, dino_feats = encode_frames(cfg, params, flat_sig, flat_dino, attn_impl=attn_impl,
                                            remat=remat_encode)
    P = frame_feats.shape[1]
    return prepare_multimodal_from_features(
        cfg, params, input_ids, image_pos, frame_feats.reshape(B, T, P, -1),
        dino_feats.reshape(B, T, dino_feats.shape[1], -1), frame_mask, qformer_text_ids,
        qformer_text_mask, audio_tokens=audio_tokens, labels=labels, text_len=text_len,
        has_image=has_image, token_valid=token_valid, query_pool=query_pool, max_len=max_len,
        max_visual_len=max_visual_len, remat_encode=remat_encode,
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
    audio_tokens: Optional[torch.Tensor] = None,  # [B, T, 50, H]
    labels: Optional[torch.Tensor] = None,  # [B, L]
    text_len: Optional[torch.Tensor] = None,  # [B]
    has_image: Optional[torch.Tensor] = None,  # [B] bool; False rows splice no visual
    token_valid: Optional[torch.Tensor] = None,  # [B, P]
    query_pool: Optional[torch.Tensor] = None,  # [B, K, P]
    max_len: int = 4096,
    max_visual_len: int = 2048,
    remat_encode: bool = False,
) -> Dict[str, torch.Tensor]:
    """Compression + splice over pre-encoded frames.  JAX vmaps over the
    batch; here compression loops over the samples (each has its own
    segments and chunks) and the splice runs batched.  remat_encode=True
    (training) checkpoints each sample's segment+compress stage, so only its
    inputs are kept for the backward."""
    B, T = frame_mask.shape
    P = frame_feats.shape[2]
    dev = frame_feats.device
    if token_valid is None:
        token_valid = torch.ones((B, P), dtype=torch.bool, device=dev)
    if query_pool is None:
        K = cfg.compression.context_token_num
        query_pool = torch.from_numpy(adaptive_pool_matrix(P, K)).to(dev)[None].expand(B, K, P)

    def one(ff, df, fm, tid, tmask, tv, qp, atok):
        return prepare_visual(cfg, params, ff, df, fm, tid, tmask, atok,
                              max_visual_len=max_visual_len, token_valid=tv, query_pool=qp,
                              remat=remat_encode)

    vis, nvis = [], []
    for b in range(B):
        args = (frame_feats[b], dino_feats[b], frame_mask[b],
                None if qformer_text_ids is None else qformer_text_ids[b],
                None if qformer_text_mask is None else qformer_text_mask[b],
                token_valid[b], query_pool[b],
                None if audio_tokens is None else audio_tokens[b])
        v, nv = checkpoint(one, *args, use_reentrant=False) if remat_encode else one(*args)
        vis.append(v)
        nvis.append(nv)
    text_embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], input_ids, cfg.dtype)
    visual = torch.stack(vis).to(text_embeds.dtype)
    if text_len is None:
        text_len = torch.full((B,), input_ids.shape[1], dtype=torch.int32, device=dev)
    embeds, attn_mask, out_labels, seq_len = splice_visual_dynamic(
        text_embeds, image_pos, visual, torch.stack(nvis), max_len, labels=labels,
        text_len=text_len, has_image=has_image,
    )
    return {"embeds": embeds, "attn_mask": attn_mask, "labels": out_labels, "seq_len": seq_len}


def prepare_multimodal_multi_image(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, L]
    image_pos_multi: torch.Tensor,  # [B, M] ascending <image> positions, -1 pad
    siglip_px: torch.Tensor,  # [B, M, Hs, Ws, 3] one image per slot
    dino_px: torch.Tensor,  # [B, M, Hd, Wd, 3]
    labels: Optional[torch.Tensor] = None,  # [B, L]
    text_len: Optional[torch.Tensor] = None,  # [B]
    max_len: int = 4096,
    attn_impl: str = "xla",
) -> Dict[str, torch.Tensor]:
    """Stage-1-style conversations with several <image> tokens per sample
    (JAX :433-482): each image contributes its uncompressed SVA grid (plus
    newline) tokens, no TDC compression, as the reference's image path."""
    from .compress.assembly import splice_visual_multi

    B, M = image_pos_multi.shape
    flat_sig = siglip_px.reshape((B * M,) + siglip_px.shape[2:])
    flat_dino = dino_px.reshape((B * M,) + dino_px.shape[2:])
    feats, _ = encode_frames(cfg, params, flat_sig, flat_dino, attn_impl=attn_impl)
    P = feats.shape[1]
    text_embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], input_ids, cfg.dtype)
    visual = feats.reshape(B, M, P, -1).to(text_embeds.dtype)
    n_visual = torch.full((B, M), P, dtype=torch.int32, device=input_ids.device)
    if text_len is None:
        text_len = torch.full((B,), input_ids.shape[1], dtype=torch.int32, device=input_ids.device)
    embeds, attn_mask, out_labels, seq_len = splice_visual_multi(
        text_embeds, image_pos_multi, visual, n_visual, max_len, labels=labels, text_len=text_len)
    return {"embeds": embeds, "attn_mask": attn_mask, "labels": out_labels, "seq_len": seq_len}


def tdc_loss(
    cfg: TDCConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    max_len: int = 4096,
    max_visual_len: int = 2048,
    attn_impl: str = "xla",
    remat: bool = True,
    loss_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Training loss for a multimodal batch (JAX :485-535): encode, compress,
    splice, LM cross-entropy.  Audio comes as precomputed `audio_tokens` or
    as raw `audio_windows` with their masks and second groups."""
    mm = prepare_multimodal_inputs(
        cfg, params, batch["input_ids"], batch["image_pos"], batch["siglip_px"],
        batch["dino_px"], batch["frame_mask"], batch.get("qformer_text_ids"),
        batch.get("qformer_text_mask"), audio_tokens=batch.get("audio_tokens"),
        audio_windows=batch.get("audio_windows"), audio_wmask=batch.get("audio_wmask"),
        audio_frame_of_sec=batch.get("audio_frame_of_sec"),
        audio_group_pos=batch.get("audio_group_pos"),
        audio_group_size=batch.get("audio_group_size"),
        audio_sec_valid=batch.get("audio_sec_valid"), labels=batch["labels"],
        text_len=batch.get("text_len"),
        has_image=batch.get("has_image"), token_valid=batch.get("token_valid"),
        query_pool=batch.get("query_pool"), max_len=max_len, max_visual_len=max_visual_len,
        attn_impl=attn_impl, remat_encode=remat,
    )
    return lm_mod.lm_loss(cfg.lm, params["lm"], mm["embeds"], mm["labels"], mm["attn_mask"],
                          attn_impl=attn_impl, remat=remat, dtype=cfg.dtype, loss_chunk=loss_chunk)
