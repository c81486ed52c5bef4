"""Generation: multimodal prefill, then the plain decode loop or prompt-lookup
speculative decoding (serving/speculative.py), greedy or sampled, over a
bf16 or int8 KV cache, with weight-only or act-quant int8 prefill (port of
tdc_video_tpu/serving/generate.py).

Sampling is HF's warper order (temperature -> top-k -> top-p ->
categorical), drawn with JAX's threefry keys (serving/prng.py), so that a
sampled stream is JAX's token for token: the plain loop splits its key once
a step, and the engine's rows (sample_rows) key each token on (seed, token
index).

JAX runs decode as one lax.while_loop on the device; here it is a Python
loop.  Its stop test (every row done) is read back to the host only every
DONE_CHECK_EVERY steps, not every token: rows already done emit pad, so
the tokens are the same, and the loop runs at most DONE_CHECK_EVERY - 1
steps past the last EOS.

`mesh` (parallel/mesh.py) runs the LM tensor-parallel on this rank's
shard of the params: every rank gets the full logits (models/lm.lm_head),
so every rank takes the same tokens and the same stop decisions, and no
rank leaves a collective that another waits in.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import TDCConfig
from ..device import synchronize
from ..model import prepare_multimodal_from_features, prepare_multimodal_inputs
from ..models import lm as lm_mod
from . import prng

Params = Any

# decode steps between two host reads of the stop condition
DONE_CHECK_EVERY = 8


def greedy_sample(logits: torch.Tensor, _key=None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits: torch.Tensor, key: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    return prng.categorical(key, logits / temperature).to(torch.int32)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, -inf the rest (HF TopKLogitsWarper)."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, float("-inf"), logits)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's formula: exp(x - max) over its sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (HF TopPLogitsWarper): keep the smallest prefix of
    descending-probability tokens whose mass reaches p (the token crossing
    it is kept; ties at the cut are kept)."""
    s = torch.sort(logits, dim=-1, descending=True).values
    probs = _softmax(s)
    keep = (torch.cumsum(probs, dim=-1) - probs) < p
    kth = torch.where(keep, s, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logits < kth, float("-inf"), logits)


def sample_logits(logits: torch.Tensor, key: Optional[torch.Tensor], temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """HF-generate sampling: temperature 0 is greedy; otherwise temperature
    -> top-k -> top-p -> categorical with `key` (the reference demo's
    do_sample=True, temperature=0.2 with HF's default top_k=50)."""
    if temperature == 0.0:
        return greedy_sample(logits)
    x = logits.float() / temperature
    if top_k and top_k > 0:
        x = top_k_filter(x, min(top_k, x.shape[-1]))
    if top_p < 1.0:
        x = top_p_filter(x, top_p)
    return prng.categorical(key, x).to(torch.int32)


def filter_rows(x: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature -> top-k -> top-p warping (HF order) of f32
    logits [S, V] for independent requests: temperature [S] f32, top_k [S]
    (<= 0 keeps all), top_p [S] (>= 1 keeps all, exactly)."""
    V = x.shape[-1]
    xt = x / temperature.clamp_min(1e-6)[:, None]
    s = torch.sort(xt, dim=-1, descending=True).values
    # top-k: threshold at the k-th largest (ties at the cut survive)
    k = torch.where(top_k > 0, top_k.clamp_max(V), V).long()
    kth = torch.take_along_dim(s, (k - 1)[:, None], dim=-1)
    xt = torch.where(xt < kth, float("-inf"), xt)
    # top-p over the k-filtered row, whose sort is the sorted row with the
    # values under the threshold at -inf
    s = torch.where(s < kth, float("-inf"), s)
    probs = _softmax(s)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p.clamp_min(1e-9)[:, None]
    pth = torch.where(keep, s, float("inf")).amin(dim=-1, keepdim=True)
    # top_p >= 1 disables the filter exactly: an f32 cumsum can reach 1.0
    # before the tail
    pth = torch.where(top_p[:, None] >= 1.0, float("-inf"), pth)
    return torch.where(xt < pth, float("-inf"), xt)


def row_keys(seed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Counter-mode keys [S, 2]: fold_in(fold_in(PRNGKey(0), seed), idx)."""
    return prng.fold_in(prng.fold_in(prng.PRNGKey(0, device=seed.device), seed), idx)


def sample_rows(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor, seed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row HF-order sampling for the engine's slots (serving/batching.py).
    Row r draws with the key of (seed[r], idx[r]) (row_keys): a request's
    stream depends only on its seed and token index, never on its slot or
    its batchmates.  Rows with temperature <= 0 return the plain argmax, so
    greedy rows of a mixed batch keep the greedy tokens."""
    x = logits.float()
    greedy = torch.argmax(x, dim=-1).to(torch.int32)
    xt = filter_rows(x, temperature, top_k, top_p)
    sampled = prng.categorical(row_keys(seed, idx), xt).to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy)


def decode_loop(
    cfg: TDCConfig,
    params: Params,
    cache: Dict,
    first_token: torch.Tensor,  # [B] int32
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    key: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    mesh=None,
) -> Tuple[torch.Tensor, int]:
    """Decode for up to max_new_tokens, greedy or sampled (one key split a
    step, as JAX's loop); stops early once every row has emitted an EOS, as
    seen at the next of the host checks (every DONE_CHECK_EVERY steps).
    Returns (tokens [B, max_new_tokens] with positions after EOS set to
    pad_token_id, decode steps run)."""
    B = first_token.shape[0]
    dev = first_token.device
    eos = torch.tensor(cfg.lm.eos_token_ids, dtype=torch.int32, device=dev)
    pad = cfg.lm.pad_token_id
    if key is None:
        key = prng.PRNGKey(0, device=dev)
    out = torch.full((B, max_new_tokens), pad, dtype=torch.int32, device=dev)
    out[:, 0] = first_token
    done = (first_token[:, None] == eos[None]).any(-1)
    tok = first_token
    i = 1
    while i < max_new_tokens:
        if (i - 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], tok[:, None], cfg.dtype, mesh)
        logits, cache = lm_mod.decode_step(cfg.lm, params["lm"], embeds, cache,
                                           attn_impl=attn_impl, dtype=cfg.dtype, mesh=mesh)
        key, sub = prng.split(key)
        nxt = sample_logits(logits, sub, temperature, top_k, top_p)
        nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
        out[:, i] = nxt
        done = done | (nxt[:, None] == eos[None]).any(-1)
        tok = nxt
        i += 1
    return out, i - 1


def _spec_or_plain_decode(cfg, params, cache, first, input_ids, prompt_len, max_new_tokens,
                          temperature, top_k, top_p, key, attn_impl, spec_window, spec_ngram,
                          mesh=None):
    """Prompt-lookup speculative decode when spec_window >= 2 and decoding
    is greedy (exact there), else the plain loop.  Returns (tokens, steps)."""
    if spec_window and spec_window >= 2 and temperature == 0.0:
        from .speculative import pld_decode_loop

        return pld_decode_loop(cfg, params, cache, first, input_ids, prompt_len, max_new_tokens,
                               window=spec_window, ngram=spec_ngram, attn_impl=attn_impl,
                               mesh=mesh)
    return decode_loop(cfg, params, cache, first, max_new_tokens, temperature=temperature,
                       top_k=top_k, top_p=top_p, key=key, attn_impl=attn_impl, mesh=mesh)


def _sample_first(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
                  top_p: float = 1.0, key: Optional[torch.Tensor] = None):
    """First generated token from the prefill logits; returns (token, key),
    the key split once when sampling."""
    if temperature == 0.0:
        return greedy_sample(logits), key
    key = prng.PRNGKey(0, device=logits.device) if key is None else key
    key, sub = prng.split(key)
    return sample_logits(logits, sub, temperature, top_k, top_p), key


def _prompt_len(input_ids: torch.Tensor, text_len: Optional[torch.Tensor]) -> torch.Tensor:
    # drafts come from the text ids (visual tokens have no token identity)
    if text_len is not None:
        return text_len
    return torch.full((input_ids.shape[0],), input_ids.shape[1], dtype=torch.int32,
                      device=input_ids.device)


def _decode_from_prefill(cfg, params, input_ids, prompt_len, logits, cache, max_new_tokens,
                         temperature, top_k, top_p, key, attn_impl, spec_window, spec_ngram,
                         mesh=None):
    first, key = _sample_first(logits, temperature, top_k, top_p, key)
    return _spec_or_plain_decode(cfg, params, cache, first, input_ids, prompt_len,
                                 max_new_tokens, temperature, top_k, top_p, key, attn_impl,
                                 spec_window, spec_ngram, mesh)


def generate(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, L]
    image_pos: torch.Tensor,  # [B]
    siglip_px: torch.Tensor,  # [B, T, Hs, Ws, 3]
    dino_px: torch.Tensor,  # [B, T, Hd, Wd, 3]
    frame_mask: torch.Tensor,
    qformer_text_ids: Optional[torch.Tensor] = None,
    qformer_text_mask: Optional[torch.Tensor] = None,
    audio_tokens: Optional[torch.Tensor] = None,
    text_len: Optional[torch.Tensor] = None,
    token_valid: Optional[torch.Tensor] = None,
    query_pool: Optional[torch.Tensor] = None,
    max_new_tokens: int = 64,
    max_len: int = 4096,
    max_visual_len: int = 2048,
    temperature: float = 0.0,
    top_k: int = 50,
    top_p: float = 1.0,
    key: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    kv_quant: Optional[str] = None,
    act_quant: bool = False,
    spec_window: int = 0,
    spec_ngram: int = 3,
    mesh=None,
) -> torch.Tensor:
    """End-to-end multimodal generation from pixels (the reference main.py:60
    round trip); returns generated ids [B, max_new_tokens].  Under a mesh
    the frames split over `data` and the LM over `model`."""
    mm = prepare_multimodal_inputs(
        cfg, params, input_ids, image_pos, siglip_px, dino_px, frame_mask, qformer_text_ids,
        qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len, token_valid=token_valid,
        query_pool=query_pool, max_len=max_len, max_visual_len=max_visual_len,
        attn_impl=attn_impl, mesh=mesh,
    )
    capacity = max_len + max_new_tokens + max(spec_window - 1, 0)
    cache = lm_mod.init_kv_cache(cfg.lm, input_ids.shape[0], capacity, dtype=cfg.dtype,
                                 device=input_ids.device, quant=kv_quant, mesh=mesh)
    logits, cache = lm_mod.prefill(cfg.lm, params["lm"], mm["embeds"], mm["attn_mask"], cache,
                                   attn_impl=attn_impl, dtype=cfg.dtype, act_quant=act_quant,
                                   mesh=mesh)
    return _decode_from_prefill(cfg, params, input_ids, _prompt_len(input_ids, text_len), logits,
                                cache, max_new_tokens, temperature, top_k, top_p, key, attn_impl,
                                spec_window, spec_ngram, mesh)[0]


def generate_text_only(
    cfg: TDCConfig,
    params: Params,
    input_ids: torch.Tensor,  # [B, L] right-padded
    attention_mask: torch.Tensor,  # [B, L]
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 50,
    top_p: float = 1.0,
    key: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    kv_quant: Optional[str] = None,
    act_quant: bool = False,
    spec_window: int = 0,
    spec_ngram: int = 3,
    mesh=None,
) -> torch.Tensor:
    """Text-only generation (parity harness and text-only eval rows);
    returns [B, max_new_tokens]."""
    B, L = input_ids.shape
    embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], input_ids, cfg.dtype, mesh)
    capacity = L + max_new_tokens + max(spec_window - 1, 0)
    cache = lm_mod.init_kv_cache(cfg.lm, B, capacity, dtype=cfg.dtype, device=input_ids.device,
                                 quant=kv_quant, mesh=mesh)
    logits, cache = lm_mod.prefill(cfg.lm, params["lm"], embeds, attention_mask, cache,
                                   attn_impl=attn_impl, dtype=cfg.dtype, act_quant=act_quant,
                                   mesh=mesh)
    prompt_len = attention_mask.to(torch.int32).sum(-1)
    return _decode_from_prefill(cfg, params, input_ids, prompt_len, logits, cache, max_new_tokens,
                                temperature, top_k, top_p, key, attn_impl, spec_window,
                                spec_ngram, mesh)[0]


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
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """Compression + splice + LM prefill into a cache (int8 with
    kv_quant="int8") of capacity max_len + max_new_tokens, plus
    spec_window - 1 slots of headroom for speculative verify windows.
    Returns (last-token logits [B, V], cache)."""
    mm = prepare_multimodal_from_features(
        cfg, params, input_ids, image_pos, frame_feats, dino_feats, frame_mask,
        qformer_text_ids, qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len,
        token_valid=token_valid, query_pool=query_pool, max_len=max_len,
        max_visual_len=max_visual_len, mesh=mesh,
    )
    B = input_ids.shape[0]
    capacity = max_len + max_new_tokens + max(spec_window - 1, 0)
    cache = lm_mod.init_kv_cache(cfg.lm, B, capacity, dtype=cfg.dtype, device=input_ids.device,
                                 quant=kv_quant, mesh=mesh)
    return lm_mod.prefill(cfg.lm, params["lm"], mm["embeds"], mm["attn_mask"], cache,
                          attn_impl=attn_impl, dtype=cfg.dtype, act_quant=act_quant, mesh=mesh)


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
    temperature: float = 0.0,
    top_k: int = 50,
    top_p: float = 1.0,
    key: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    timings: Optional[Dict[str, float]] = None,
    kv_quant: Optional[str] = None,  # "int8": int8 KV cache
    act_quant: bool = False,  # s8 x s8 prefill projections (int8 weights)
    spec_window: int = 0,  # >= 2: prompt-lookup speculative decode (greedy)
    spec_ngram: int = 3,
    mesh=None,  # tensor-parallel LM over the mesh's model axis
) -> torch.Tensor:
    """Generation over pre-encoded frames; returns [B, max_new_tokens].
    `timings`, when given, receives prefill_s (compression + splice +
    prefill), decode_s and decode_steps (verify steps under speculation),
    each stage ended by a device sync."""
    t0 = time.perf_counter()
    logits, cache = prefill_encoded(
        cfg, params, input_ids, image_pos, frame_feats, dino_feats, frame_mask,
        qformer_text_ids, qformer_text_mask, audio_tokens=audio_tokens, text_len=text_len,
        token_valid=token_valid, query_pool=query_pool, max_new_tokens=max_new_tokens,
        max_len=max_len, max_visual_len=max_visual_len, attn_impl=attn_impl, kv_quant=kv_quant,
        act_quant=act_quant, spec_window=spec_window, mesh=mesh,
    )
    if timings is not None:
        synchronize(logits.device)
        t1 = time.perf_counter()
    out, steps = _decode_from_prefill(cfg, params, input_ids, _prompt_len(input_ids, text_len),
                                      logits, cache, max_new_tokens, temperature, top_k, top_p,
                                      key, attn_impl, spec_window, spec_ngram, mesh)
    if timings is not None:
        synchronize(out.device)
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1, decode_steps=steps)
    return out
