"""TDC Q-Former: BERT with interleaved cross-attention, the compressor
(port of tdc_video_tpu/models/qformer.py).  Its attention is the plain
`sdpa` path, as in JAX."""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import QFormerConfig
from ..device import resolve_device
from .attention import attention
from .layers import init_layer_norm, init_linear, layer_norm, linear, normal_init

Params = Any


def _init_attn(gen, cfg: QFormerConfig, kv_dim: int, dtype, device):
    d = cfg.hidden_size
    return {
        "q_proj": init_linear(gen, d, d, dtype, device),
        "k_proj": init_linear(gen, kv_dim, d, dtype, device),
        "v_proj": init_linear(gen, kv_dim, d, dtype, device),
        "o_proj": init_linear(gen, d, d, dtype, device),
        "norm": init_layer_norm(d, dtype, device),
    }


def _init_ffn(gen, cfg: QFormerConfig, dtype, device):
    return {
        "fc1": init_linear(gen, cfg.hidden_size, cfg.intermediate_size, dtype, device),
        "fc2": init_linear(gen, cfg.intermediate_size, cfg.hidden_size, dtype, device),
        "norm": init_layer_norm(cfg.hidden_size, dtype, device),
    }


def init_qformer(cfg: QFormerConfig, gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    device = resolve_device(device)
    layers = []
    for i in range(cfg.num_layers):
        layers.append({
            "self_attn": _init_attn(gen, cfg, cfg.hidden_size, dtype, device),
            "cross_attn": (
                _init_attn(gen, cfg, cfg.encoder_width, dtype, device)
                if i % cfg.cross_attention_freq == 0 else None
            ),
            "ffn": _init_ffn(gen, cfg, dtype, device),
            "ffn_query": _init_ffn(gen, cfg, dtype, device),
        })
    return {
        "embeddings": {
            "word": normal_init(gen, (cfg.vocab_size, cfg.hidden_size), dtype, device),
            "position": normal_init(gen, (cfg.max_position_embeddings, cfg.hidden_size), dtype, device),
            "norm": init_layer_norm(cfg.hidden_size, dtype, device),
        },
        "layers": layers,
    }


def _attn_block(cfg: QFormerConfig, p: Params, x, kv, mask: Optional[torch.Tensor]):
    B, T, _ = x.shape
    S = kv.shape[1]
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    q = linear(p["q_proj"], x).reshape(B, T, nh, hd)
    k = linear(p["k_proj"], kv).reshape(B, S, nh, hd)
    v = linear(p["v_proj"], kv).reshape(B, S, nh, hd)
    m = mask[:, None, None, :] if mask is not None else None
    a = linear(p["o_proj"], attention(q, k, v, m).reshape(B, T, cfg.hidden_size))
    return layer_norm(p["norm"], a + x, cfg.layer_norm_eps)


def _ffn_block(cfg: QFormerConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = linear(p["fc2"], F.gelu(linear(p["fc1"], x)))  # exact (erf) GELU
    return layer_norm(p["norm"], h + x, cfg.layer_norm_eps)


def qformer_forward(
    cfg: QFormerConfig,
    params: Params,
    query_embeds: torch.Tensor,  # [B, Q, H]
    input_ids: Optional[torch.Tensor],  # [B, L] or None
    text_mask: Optional[torch.Tensor],  # [B, L] bool
    encoder_hidden: torch.Tensor,  # [B, S, E]
    encoder_mask: Optional[torch.Tensor] = None,  # [B, S] bool
    dtype=torch.float32,
    remat: bool = False,
) -> torch.Tensor:
    """Returns hidden states of the query positions [B, Q, H].  remat=True
    (training) checkpoints each layer, as JAX does."""
    B, Q, _ = query_embeds.shape
    emb = params["embeddings"]
    x = query_embeds.to(dtype)
    dev = x.device
    if input_ids is not None:
        L = input_ids.shape[1]
        tok = emb["word"].to(dtype)[input_ids.long()]
        pos = emb["position"].to(dtype)[:L]
        x = torch.cat([x, tok + pos[None]], dim=1)
        key_mask = torch.cat([torch.ones((B, Q), dtype=torch.bool, device=dev),
                              text_mask.to(torch.bool)], dim=1)
    else:
        key_mask = torch.ones((B, Q), dtype=torch.bool, device=dev)
    x = layer_norm(emb["norm"], x, cfg.layer_norm_eps)
    enc = encoder_hidden.to(dtype)

    def one_layer(layer, x):
        x = _attn_block(cfg, layer["self_attn"], x, x, key_mask)
        q_part, t_part = x[:, :Q], x[:, Q:]
        if layer["cross_attn"] is not None:
            q_part = _attn_block(cfg, layer["cross_attn"], q_part, enc, encoder_mask)
        q_part = _ffn_block(cfg, layer["ffn_query"], q_part)
        if x.shape[1] > Q:
            return torch.cat([q_part, _ffn_block(cfg, layer["ffn"], t_part)], dim=1)
        return q_part

    for layer in params["layers"]:
        x = checkpoint(one_layer, layer, x, use_reentrant=False) if remat else one_layer(layer, x)
    return x[:, :Q]
