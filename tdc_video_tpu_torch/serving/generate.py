"""Greedy generation over pre-encoded frames (port of the greedy paths of
tdc_video_tpu/serving/generate.py): the plain decode loop, or prompt-lookup
speculative decoding (serving/speculative.py), over a bf16 or int8 KV
cache, with weight-only or act-quant int8 prefill.

JAX runs decode as one lax.while_loop on the device; here it is a Python
loop.  Its stop test (every row done) is read back to the host only every
DONE_CHECK_EVERY steps, not every token: rows already done emit pad, so
the tokens are the same, and the loop runs at most DONE_CHECK_EVERY - 1
steps past the last EOS.
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

# decode steps between two host reads of the stop condition
DONE_CHECK_EVERY = 8


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
    emitted an EOS, as seen at the next of the host checks (every
    DONE_CHECK_EVERY steps).  Returns (tokens [B, max_new_tokens] with
    positions after EOS set to pad_token_id, decode steps run)."""
    B = first_token.shape[0]
    dev = first_token.device
    eos = torch.tensor(cfg.lm.eos_token_ids, dtype=torch.int32, device=dev)
    pad = cfg.lm.pad_token_id
    out = torch.full((B, max_new_tokens), pad, dtype=torch.int32, device=dev)
    out[:, 0] = first_token
    done = (first_token[:, None] == eos[None]).any(-1)
    tok = first_token
    i = 1
    while i < max_new_tokens:
        if (i - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], tok[:, None], cfg.dtype)
        logits, cache = lm_mod.decode_step(cfg.lm, params["lm"], embeds, cache,
                                           attn_impl=attn_impl, dtype=cfg.dtype)
        nxt = torch.where(done, torch.full_like(tok, pad), greedy_sample(logits))
        out[:, i] = nxt
        done = done | (nxt[:, None] == eos[None]).any(-1)
        tok = nxt
        i += 1
    return out, i - 1


def _spec_or_plain_decode(cfg, params, cache, first, input_ids, prompt_len, max_new_tokens,
                          attn_impl, spec_window, spec_ngram):
    """Prompt-lookup speculative decode when spec_window >= 2 (exact for
    greedy decoding, the port's only mode), else the plain loop.  Returns
    (tokens, steps)."""
    if spec_window and spec_window >= 2:
        from .speculative import pld_decode_loop

        return pld_decode_loop(cfg, params, cache, first, input_ids, prompt_len, max_new_tokens,
                               window=spec_window, ngram=spec_ngram, attn_impl=attn_impl)
    return decode_loop(cfg, params, cache, first, max_new_tokens, attn_impl=attn_impl)


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
    kv_quant: Optional[str] = None,
    act_quant: bool = False,
    spec_window: int = 0,
) -> Tuple[torch.Tensor, Dict]:
    """Compression + splice + LM prefill into a cache (int8 with
    kv_quant="int8") of capacity max_len + max_new_tokens, plus
    spec_window - 1 slots of headroom for speculative verify windows.
    Returns (last-token logits [B, V], cache)."""
    mm = prepare_multimodal_from_features(
        cfg, params, input_ids, image_pos, frame_feats, dino_feats, frame_mask,
        qformer_text_ids, qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len,
        token_valid=token_valid, query_pool=query_pool, max_len=max_len,
        max_visual_len=max_visual_len,
    )
    B = input_ids.shape[0]
    capacity = max_len + max_new_tokens + max(spec_window - 1, 0)
    cache = lm_mod.init_kv_cache(cfg.lm, B, capacity, dtype=cfg.dtype, device=input_ids.device,
                                 quant=kv_quant)
    return lm_mod.prefill(cfg.lm, params["lm"], mm["embeds"], mm["attn_mask"], cache,
                          attn_impl=attn_impl, dtype=cfg.dtype, act_quant=act_quant)


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
    kv_quant: Optional[str] = None,  # "int8": int8 KV cache
    act_quant: bool = False,  # s8 x s8 prefill projections (int8 weights)
    spec_window: int = 0,  # >= 2: prompt-lookup speculative decode
    spec_ngram: int = 3,
) -> torch.Tensor:
    """Greedy generation over pre-encoded frames; returns [B, max_new_tokens].
    `timings`, when given, receives prefill_s (compression + splice +
    prefill), decode_s and decode_steps (verify steps under speculation),
    each stage ended by a device sync."""
    B, dev = input_ids.shape[0], input_ids.device
    t0 = time.perf_counter()
    logits, cache = prefill_encoded(
        cfg, params, input_ids, image_pos, frame_feats, dino_feats, frame_mask,
        qformer_text_ids, qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len,
        token_valid=token_valid, query_pool=query_pool, max_new_tokens=max_new_tokens,
        max_len=max_len,
        max_visual_len=max_visual_len, attn_impl=attn_impl, kv_quant=kv_quant,
        act_quant=act_quant, spec_window=spec_window,
    )
    first = _sample_first(logits)
    if timings is not None:
        synchronize(logits.device)
        t1 = time.perf_counter()
    # drafts come from the text ids (visual tokens have no token identity)
    prompt_len = (text_len if text_len is not None
                  else torch.full((B,), input_ids.shape[1], dtype=torch.int32, device=dev))
    out, steps = _spec_or_plain_decode(cfg, params, cache, first, input_ids, prompt_len,
                                       max_new_tokens, attn_impl, spec_window, spec_ngram)
    if timings is not None:
        synchronize(out.device)
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1, decode_steps=steps)
    return out
