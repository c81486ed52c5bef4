"""Decoder-only language model core, Qwen2 / Llama-3.x (port of
tdc_video_tpu/models/lm.py, float path with a bf16 KV cache).

Layers are stacked on axis 0 and run in a Python loop; `layers` may also be
a list of per-layer trees (the trainer's gradient views, train/step.py).  The
KV cache is a fixed-capacity buffer with a validity mask and per-sample
lengths, as in JAX; unlike JAX it is updated in place (prefill and
decode_step write the new keys/values into the cache tensors they are given
and return the same dict), which saves a copy of the whole cache per step.

Training: `lm_forward` and `lm_loss` (chunked cross-entropy), with
`remat=True` checkpointing each layer (torch.utils.checkpoint in place of
jax.checkpoint).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

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
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Run the decoder stack; returns (final hidden [B,T,H], cache).
    remat=True (training) checkpoints each layer: the backward keeps only the
    layer inputs and recomputes each layer's internals (JAX :241-242)."""
    x = inputs_embeds.to(dtype)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=x.device)
    cos, sin = rope_cos_sin(positions, inv_freq)
    layer_fn = functools.partial(_layer_forward, cfg)
    if remat:
        layer_fn = functools.partial(checkpoint, layer_fn, use_reentrant=False)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        lp = layer_params(layers, i)
        ck = cache["k"][i] if cache is not None else None
        cv = cache["v"][i] if cache is not None else None
        x = layer_fn(lp, x, cos, sin, attn_mask, ck, cv, write_pos, attn_impl, causal)
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps), cache


def _tree_index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(layers, i: int):
    """Layer i's params from a stacked tree or from a list of per-layer trees."""
    return layers[i] if isinstance(layers, list) else _tree_index(layers, i)


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
# Training / scoring
# ---------------------------------------------------------------------------


def lm_forward(
    cfg: LMConfig,
    params: Params,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, T] bool, True = valid
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    remat: bool = False,
    dtype=torch.bfloat16,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Full-sequence causal forward (training / scoring): f32 logits [B,T,V],
    or the final hidden states when return_hidden (the chunked loss applies
    the head itself).  JAX's seq_axis (sequence sharding) and act_quant
    (int8 activations) are not ported."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(cfg, params, input_ids, dtype)
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if positions is None:
        positions = (torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    mask = causal[None, None] & attention_mask.to(torch.bool)[:, None, None, :]
    hidden, _ = lm_backbone(cfg, params, inputs_embeds, positions, mask, attn_impl=attn_impl,
                            dtype=dtype, causal=True, remat=remat)
    if return_hidden:
        return hidden
    return lm_head(cfg, params, hidden)


def _token_ll(cfg: LMConfig, params: Params, hidden, targets, valid) -> torch.Tensor:
    """Sum over valid positions of log p(target): f32 head and log-softmax."""
    logp = torch.log_softmax(lm_head(cfg, params, hidden).float(), dim=-1)
    ll = torch.take_along_dim(logp, targets[..., None].long(), dim=-1)[..., 0]
    return (ll * valid).sum()


def lm_loss(
    cfg: LMConfig,
    params: Params,
    inputs_embeds: torch.Tensor,
    labels: torch.Tensor,  # [B, T], IGNORE_INDEX = ignored
    attention_mask: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    remat: bool = True,
    dtype=torch.bfloat16,
    loss_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Shifted cross-entropy over valid label positions (JAX :362-443).

    loss_chunk: the head and the log-softmax run over chunks of this many
    positions, each chunk checkpointed, so the backward recomputes a chunk's
    [B, C, V] f32 logits instead of holding the full [B, T, V] (4.2 GB per
    buffer at 8k tokens and a 128k vocabulary)."""
    targets = labels[:, 1:]
    valid = targets >= 0
    safe_targets = torch.where(valid, targets, 0).clamp(0, cfg.vocab_size - 1)
    denom = valid.sum().clamp_min(1)
    hidden = lm_forward(cfg, params, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                        positions=positions, attn_impl=attn_impl, remat=remat, dtype=dtype,
                        return_hidden=True)
    h = hidden[:, :-1]
    vf = valid.to(torch.float32)
    if loss_chunk is None:
        return -_token_ll(cfg, params, h, safe_targets, vf) / denom
    C = int(loss_chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], C):
        sl = slice(c0, c0 + C)
        total = total + checkpoint(_token_ll, cfg, params, h[:, sl], safe_targets[:, sl], vf[:, sl],
                                   use_reentrant=False)
    return -total / denom


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
