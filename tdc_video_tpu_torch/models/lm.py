"""Decoder-only language model core, Qwen2 / Llama-3.x (port of
tdc_video_tpu/models/lm.py, float path with a bf16 KV cache).

Layers are stacked on axis 0 and run in a Python loop.  The KV cache is a
fixed-capacity buffer with a validity mask and per-sample lengths, as in
JAX; unlike JAX it is updated in place (prefill and decode_step write the
new keys/values into the cache tensors they are given and return the same
dict), which saves a copy of the whole cache per step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import LMConfig
from ..device import resolve_device
from .attention import attention
from .layers import (
    apply_rope,
    dot_f32,
    init_linear,
    init_rms_norm,
    linear,
    normal_init,
    rms_norm,
    rope_cos_sin,
    rope_inv_freq,
    swiglu_mlp,
)

Params = Any


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack(layers):
    """List of identical param trees -> one tree with leaves stacked on axis 0."""
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def _init_layer(gen, cfg: LMConfig, dtype, device):
    bias = cfg.attention_bias
    H, F = cfg.hidden_size, cfg.intermediate_size
    return {
        "input_norm": init_rms_norm(H, dtype, device),
        "q_proj": init_linear(gen, H, cfg.q_dim, dtype, device, bias=bias),
        "k_proj": init_linear(gen, H, cfg.kv_dim, dtype, device, bias=bias),
        "v_proj": init_linear(gen, H, cfg.kv_dim, dtype, device, bias=bias),
        "o_proj": init_linear(gen, cfg.q_dim, H, dtype, device, bias=False),
        "post_attn_norm": init_rms_norm(H, dtype, device),
        "mlp": {
            "gate": init_linear(gen, H, F, dtype, device, bias=False),
            "up": init_linear(gen, H, F, dtype, device, bias=False),
            "down": init_linear(gen, F, H, dtype, device, bias=False),
        },
    }


def init_lm(cfg: LMConfig, gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    device = resolve_device(device)
    params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, cfg.hidden_size), dtype, device)},
        "layers": _stack([_init_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)]),
        "final_norm": init_rms_norm(cfg.hidden_size, dtype, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init_linear(gen, cfg.hidden_size, cfg.vocab_size, dtype, device,
                                        bias=False)
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LMConfig, batch: int, capacity: int, dtype=torch.bfloat16,
                  device=None) -> Dict:
    """Fixed-capacity KV cache [L, B, S, Hkv, D] (the bf16 branch of JAX's)."""
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "mask": torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_forward(
    cfg: LMConfig,
    p: Params,
    x: torch.Tensor,  # [B, T, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_mask: Optional[torch.Tensor],  # [B, 1, T, S] bool
    cache_k: Optional[torch.Tensor],  # [B, S, Hkv, D], written in place
    cache_v: Optional[torch.Tensor],
    write_pos: Optional[torch.Tensor],  # [B, T] slot indices for the new k/v
    attn_impl: str,
    causal: bool = False,
) -> torch.Tensor:
    B, T, _ = x.shape
    h = rms_norm(p["input_norm"], x, cfg.rms_norm_eps)
    q = linear(p["q_proj"], h).reshape(B, T, cfg.num_heads, cfg.head_dim)
    k = linear(p["k_proj"], h).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = linear(p["v_proj"], h).reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache_k is not None:
        b_idx = torch.arange(B, device=x.device)[:, None]
        cache_k[b_idx, write_pos] = k.to(cache_k.dtype)
        cache_v[b_idx, write_pos] = v.to(cache_v.dtype)
        k_all, v_all = cache_k, cache_v
    else:
        k_all, v_all = k, v
    attn = attention(q, k_all.to(q.dtype), v_all.to(q.dtype), attn_mask, impl=attn_impl,
                     causal=causal)
    x = x + linear(p["o_proj"], attn.reshape(B, T, cfg.q_dim))
    h2 = rms_norm(p["post_attn_norm"], x, cfg.rms_norm_eps)
    return x + swiglu_mlp(p["mlp"], h2)


def lm_backbone(
    cfg: LMConfig,
    params: Params,
    inputs_embeds: torch.Tensor,  # [B, T, H]
    positions: torch.Tensor,  # [B, T]
    attn_mask: Optional[torch.Tensor] = None,  # [B, 1, T, S] bool
    cache: Optional[Dict] = None,
    write_pos: Optional[torch.Tensor] = None,  # [B, T]
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
    causal: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Run the decoder stack; returns (final hidden [B,T,H], cache)."""
    x = inputs_embeds.to(dtype)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=x.device)
    cos, sin = rope_cos_sin(positions, inv_freq)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = _tree_index(layers, i)
        ck = cache["k"][i] if cache is not None else None
        cv = cache["v"][i] if cache is not None else None
        x = _layer_forward(cfg, lp, x, cos, sin, attn_mask, ck, cv, write_pos, attn_impl, causal)
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps), cache


def _tree_index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def embed_tokens(cfg: LMConfig, params: Params, input_ids: torch.Tensor, dtype=torch.bfloat16):
    ids = input_ids.long().clamp(0, cfg.vocab_size - 1)  # guard sentinel ids (<image>=-200)
    return params["embed"]["embedding"].to(dtype)[ids]


def lm_head(cfg: LMConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits [B, T, V]."""
    if cfg.tie_word_embeddings:
        w = params["embed"]["embedding"].to(hidden.dtype)
        return dot_f32(hidden, w.T)
    return dot_f32(hidden, params["lm_head"]["w"].to(hidden.dtype))


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def prefill(
    cfg: LMConfig,
    params: Params,
    inputs_embeds: torch.Tensor,  # [B, T, H] right-padded
    attention_mask: torch.Tensor,  # [B, T] bool
    cache: Dict,
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill the cache; returns (last-token logits [B, V], cache).  The
    attention runs over the whole capacity-S cache with causal=True: query i
    sees cache slots j <= i (top-left causal, S >= T)."""
    B, T, _ = inputs_embeds.shape
    S = cache["k"].shape[2]
    dev = inputs_embeds.device
    am = attention_mask.to(torch.bool)
    positions = (torch.cumsum(am.to(torch.int32), dim=1) - 1).clamp_min(0)
    write_pos = torch.broadcast_to(torch.arange(T, device=dev)[None], (B, T))
    causal = (torch.arange(S, device=dev)[None] <= torch.arange(T, device=dev)[:, None])[None, None]
    key_valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
    key_valid[:, :T] = am
    mask = causal & key_valid[:, None, None, :]
    hidden, cache = lm_backbone(cfg, params, inputs_embeds, positions, mask, cache=cache,
                                write_pos=write_pos, attn_impl=attn_impl, dtype=dtype,
                                causal=True)
    lengths = am.to(torch.int32).sum(-1)
    cache["mask"][:, :T] = am
    cache["lengths"] = lengths
    last = hidden[torch.arange(B, device=dev), (lengths - 1).long()][:, None]  # [B,1,H]
    return lm_head(cfg, params, last)[:, 0], cache


def decode_step(
    cfg: LMConfig,
    params: Params,
    token_embeds: torch.Tensor,  # [B, 1, H]
    cache: Dict,
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step; writes at per-sample `lengths`, returns logits [B, V]."""
    B = token_embeds.shape[0]
    S = cache["k"].shape[2]
    dev = token_embeds.device
    lengths = cache["lengths"]
    positions = lengths[:, None]
    slot = lengths.clamp_max(S - 1).long()
    write_pos = slot[:, None]
    step_mask = cache["mask"].clone()
    step_mask[torch.arange(B, device=dev), slot] = True
    hidden, cache = lm_backbone(cfg, params, token_embeds, positions, step_mask[:, None, None, :],
                                cache=cache, write_pos=write_pos, attn_impl=attn_impl,
                                dtype=dtype)
    cache["mask"] = step_mask
    cache["lengths"] = lengths + 1
    return lm_head(cfg, params, hidden)[:, 0], cache
