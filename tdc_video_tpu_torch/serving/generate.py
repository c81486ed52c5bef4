"""Greedy generation over pre-encoded frames (port of the plain-decode path
of tdc_video_tpu/serving/generate.py).

JAX runs decode as one lax.while_loop on the device; here it is a Python
loop whose EOS test reads one bool per step back to the host: a sync per
token, and a known cost (CUDA graphs of the step would remove it).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import TDCConfig
from ..device import synchronize
from ..model import prepare_multimodal_from_features
from ..models import lm as lm_mod

Params = Any


def greedy_sample(logits: torch.Tensor, _key=None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _sample_first(logits: torch.Tensor) -> torch.Tensor:
    """First generated token from the prefill logits (greedy)."""
    return greedy_sample(logits)


def decode_loop(
    cfg: TDCConfig,
    params: Params,
    cache: Dict,
    first_token: torch.Tensor,  # [B] int32
    max_new_tokens: int,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, int]:
    """Greedy decode for up to max_new_tokens; stops early once every row has
    emitted an EOS.  Returns (tokens [B, max_new_tokens] with positions after
    EOS set to pad_token_id, decode steps run)."""
    B = first_token.shape[0]
    dev = first_token.device
    eos = torch.tensor(cfg.lm.eos_token_ids, dtype=torch.int32, device=dev)
    pad = cfg.lm.pad_token_id
    out = torch.full((B, max_new_tokens), pad, dtype=torch.int32, device=dev)
    out[:, 0] = first_token
    done = (first_token[:, None] == eos[None]).any(-1)
    tok = first_token
    i = 1
    while i < max_new_tokens and not bool(done.all()):
        embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], tok[:, None], cfg.dtype)
        logits, cache = lm_mod.decode_step(cfg.lm, params["lm"], embeds, cache,
                                           attn_impl=attn_impl, dtype=cfg.dtype)
        nxt = torch.where(done, torch.full_like(tok, pad), greedy_sample(logits))
        out[:, i] = nxt
        done = done | (nxt[:, None] == eos[None]).any(-1)
        tok = nxt
        i += 1
    return out, i - 1


def prefill_encoded(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, L]
    image_pos: torch.Tensor,  # [B]
    frame_feats: torch.Tensor,  # [B, T, P, H]
    dino_feats: torch.Tensor,  # [B, T, Nd, Cd]
    frame_mask: torch.Tensor,
    qformer_text_ids: Optional[torch.Tensor] = None,
    qformer_text_mask: Optional[torch.Tensor] = None,
    audio_tokens: Optional[torch.Tensor] = None,  # [B, T, 50, H] (encode_audio)
    text_len: Optional[torch.Tensor] = None,
    token_valid: Optional[torch.Tensor] = None,
    query_pool: Optional[torch.Tensor] = None,
    max_new_tokens: int = 64,
    max_len: int = 4096,
    max_visual_len: int = 2048,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, Dict]:
    """Compression + splice + LM prefill into a cache of capacity
    max_len + max_new_tokens.  Returns (last-token logits [B, V], cache)."""
    mm = prepare_multimodal_from_features(
        cfg, params, input_ids, image_pos, frame_feats, dino_feats, frame_mask,
        qformer_text_ids, qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len,
        token_valid=token_valid, query_pool=query_pool, max_len=max_len,
        max_visual_len=max_visual_len,
    )
    B = input_ids.shape[0]
    cache = lm_mod.init_kv_cache(cfg.lm, B, max_len + max_new_tokens, dtype=cfg.dtype,
                                 device=input_ids.device)
    return lm_mod.prefill(cfg.lm, params["lm"], mm["embeds"], mm["attn_mask"], cache,
                          attn_impl=attn_impl, dtype=cfg.dtype)


def generate_encoded(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,
    image_pos: torch.Tensor,
    frame_feats: torch.Tensor,
    dino_feats: torch.Tensor,
    frame_mask: torch.Tensor,
    qformer_text_ids: Optional[torch.Tensor] = None,
    qformer_text_mask: Optional[torch.Tensor] = None,
    audio_tokens: Optional[torch.Tensor] = None,  # [B, T, 50, H] (encode_audio)
    text_len: Optional[torch.Tensor] = None,
    token_valid: Optional[torch.Tensor] = None,
    query_pool: Optional[torch.Tensor] = None,
    max_new_tokens: int = 64,
    max_len: int = 4096,
    max_visual_len: int = 2048,
    attn_impl: str = "xla",
    timings: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Greedy generation over pre-encoded frames; returns [B, max_new_tokens].
    `timings`, when given, receives prefill_s (compression + splice +
    prefill), decode_s and decode_steps, each stage ended by a device sync."""
    t0 = time.perf_counter()
    logits, cache = prefill_encoded(
        cfg, params, input_ids, image_pos, frame_feats, dino_feats, frame_mask,
        qformer_text_ids, qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len,
        token_valid=token_valid, query_pool=query_pool, max_new_tokens=max_new_tokens,
        max_len=max_len,
        max_visual_len=max_visual_len, attn_impl=attn_impl,
    )
    first = _sample_first(logits)
    if timings is not None:
        synchronize(logits.device)
        t1 = time.perf_counter()
    out, steps = decode_loop(cfg, params, cache, first, max_new_tokens, attn_impl=attn_impl)
    if timings is not None:
        synchronize(out.device)
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1, decode_steps=steps)
    return out
