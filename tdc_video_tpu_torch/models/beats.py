"""BEATs audio encoder (port of tdc_video_tpu/models/beats.py).

A fairseq-style ViT over 128-bin Kaldi fbanks: 16x16 patch matmul -> 512-d
-> LayerNorm -> post_extract_proj to 768 -> grouped-conv positional
embedding (kernel 128, 16 groups, SamePad, exact GELU) -> a post-LN
transformer with a T5-style bucketed relative position bias shared across
layers, its gated ("grep") modulation per query, and deep-norm residual
scaling alpha = (2 L)**0.25.

The attention keeps JAX's order of operations: q scaled by hd**-0.5 / 32
before the f32-accumulated q.k, the row maximum subtracted and the result
multiplied by 32, the key mask applied as -1e30, the gates taken from the
unscaled q in f32, P cast to v's dtype before PV.  In JAX these are plain
einsums under XLA (BEATs reaches no Pallas kernel), so here they are plain
PyTorch ops.  Layers run in a Python loop over the stacked parameters.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BeatsConfig
from ..device import resolve_device
from ..ops.audio import normalize_fbank
from .layers import dot_f32, init_layer_norm, init_linear, layer_norm, linear, normal_init
from .lm import _stack, layer_params

Params = Any

ATTN_ALPHA = 32.0


def _init_layer(gen, cfg: BeatsConfig, dtype, device):
    d, f = cfg.encoder_embed_dim, cfg.ffn_dim
    hd = d // cfg.num_heads
    return {
        "q_proj": init_linear(gen, d, d, dtype, device),
        "k_proj": init_linear(gen, d, d, dtype, device),
        "v_proj": init_linear(gen, d, d, dtype, device),
        "o_proj": init_linear(gen, d, d, dtype, device),
        "attn_norm": init_layer_norm(d, dtype, device),
        "fc1": init_linear(gen, d, f, dtype, device),
        "fc2": init_linear(gen, f, d, dtype, device),
        "final_norm": init_layer_norm(d, dtype, device),
        "grep_linear": init_linear(gen, hd, 8, dtype, device),
        "grep_a": torch.ones((cfg.num_heads,), dtype=dtype, device=device),
    }


def init_beats(cfg: BeatsConfig, gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    """Random BEATs parameters with the JAX initializers' distributions."""
    device = resolve_device(device)
    d = cfg.encoder_embed_dim
    params = {
        "patch_embed": {"w": normal_init(gen, (cfg.patch_size * cfg.patch_size, cfg.embed_dim),
                                         dtype, device)},
        "patch_norm": init_layer_norm(cfg.embed_dim, dtype, device),
        "post_extract_proj": init_linear(gen, cfg.embed_dim, d, dtype, device),
        # grouped Conv1d weight [out, in / groups, kernel] + bias
        "pos_conv": {"w": normal_init(gen, (d, d // 16, 128), dtype, device,
                                      stddev=math.sqrt(4.0 / (128 * d))),
                     "b": torch.zeros((d,), dtype=dtype, device=device)},
        "encoder_norm": init_layer_norm(d, dtype, device),
        "rel_pos_bias": normal_init(gen, (cfg.num_buckets, cfg.num_heads), dtype, device),
        "layers": _stack([_init_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)]),
    }
    if cfg.conv_bias:
        params["patch_embed"]["b"] = torch.zeros((cfg.embed_dim,), dtype=dtype, device=device)
    return params


@functools.lru_cache(maxsize=32)
def relative_position_buckets(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[T, T] int32 bucket indices, bidirectional T5 bucketing."""
    ctx = np.arange(T)[:, None]
    mem = np.arange(T)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets.astype(np.int32)


def compute_position_bias(params: Params, cfg: BeatsConfig, T: int) -> torch.Tensor:
    """[num_heads, T, T] f32, shared across layers."""
    table = params["rel_pos_bias"].float()
    buckets = torch.from_numpy(relative_position_buckets(T, cfg.num_buckets, cfg.max_distance))
    return table[buckets.to(table.device, torch.int64)].permute(2, 0, 1)


def patch_embed(cfg: BeatsConfig, params: Params, fbank: torch.Tensor) -> torch.Tensor:
    """[B, F, 128] normalised fbank -> [B, (F // 16) * 8, embed_dim]: the
    16x16 stride-16 conv as one matmul over flattened patches, tokens
    time-major over the (F // 16, 8) grid."""
    B, F_, M = fbank.shape
    p = cfg.patch_size
    gt, gf = F_ // p, M // p
    x = fbank[:, : gt * p].reshape(B, gt, p, gf, p)
    x = x.permute(0, 1, 3, 2, 4).reshape(B, gt * gf, p * p)
    out = x @ params["patch_embed"]["w"].to(x.dtype)
    if "b" in params["patch_embed"]:
        out = out + params["patch_embed"]["b"].to(x.dtype)
    return out


def _pos_conv(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Grouped Conv1d positional embedding: padding 64 on both sides, the
    last step dropped (SamePad for the even kernel), bias, exact GELU.  The
    JAX `OIT` weight is torch's [O, I/G, K]."""
    w = params["pos_conv"]["w"].to(x.dtype)
    out = F.conv1d(x.transpose(1, 2), w, padding=64, groups=16).transpose(1, 2)
    out = out[:, :-1] + params["pos_conv"]["b"].to(x.dtype)
    return F.gelu(out, approximate="none")


def _layer_forward(
    cfg: BeatsConfig,
    p: Params,
    x: torch.Tensor,  # [B, T, D]
    pos_bias: torch.Tensor,  # [H, T, T] f32
    key_mask: Optional[torch.Tensor],  # [B, T] bool, True = valid
    alpha: float,
) -> torch.Tensor:
    B, T, D = x.shape
    nh = cfg.num_heads
    hd = D // nh
    q = linear(p["q_proj"], x).reshape(B, T, nh, hd)
    k = linear(p["k_proj"], x).reshape(B, T, nh, hd)
    v = linear(p["v_proj"], x).reshape(B, T, nh, hd)

    scale = hd**-0.5 / ATTN_ALPHA
    logits = dot_f32((q * scale).permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # [B, H, T, T]
    logits = (logits - logits.amax(dim=-1, keepdim=True)) * ATTN_ALPHA
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits, -1e30)

    if cfg.gru_rel_pos:
        # gated relative position: the gates come from the unscaled q
        g = linear(p["grep_linear"], q.float()).reshape(B, T, nh, 2, 4).sum(-1)
        gate = torch.sigmoid(g)  # [B, T, H, 2]
        gate_a, gate_b = gate[..., 0], gate[..., 1]
        gate_a_1 = gate_a * (gate_b * p["grep_a"].float()[None, None] - 1.0) + 2.0
        bias = gate_a_1.transpose(1, 2)[..., None] * pos_bias[None]  # [B, H, T, T]
    else:
        bias = pos_bias[None]
    logits = logits + bias

    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = (probs @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).reshape(B, T, D)
    attn = linear(p["o_proj"], attn)

    x = layer_norm(p["attn_norm"], x * alpha + attn, 1e-5)
    h = F.gelu(linear(p["fc1"], x), approximate="none")
    h = linear(p["fc2"], h)
    return layer_norm(p["final_norm"], x * alpha + h, 1e-5)


def beats_forward(
    cfg: BeatsConfig,
    params: Params,
    fbank: torch.Tensor,  # [B, F, 128] raw log-mel (normalised here)
    fbank_mask: Optional[torch.Tensor] = None,  # [B, F] bool, True = valid
    dtype=torch.float32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (features [B, T, encoder_embed_dim], token_mask [B, T] or
    None): fbank normalise -> patch embed -> LN -> proj -> pos conv ->
    post-LN encoder.  A patch row is padding only if every fbank frame
    under it is; masked tokens are zeroed before the positional conv."""
    x = normalize_fbank(fbank.float(), cfg.fbank_mean, cfg.fbank_std)
    x = patch_embed(cfg, params, x.to(dtype))
    x = layer_norm(params["patch_norm"], x, 1e-5)
    x = linear(params["post_extract_proj"], x)
    B, T, _ = x.shape

    token_mask = None
    if fbank_mask is not None:
        p = cfg.patch_size
        gt = fbank.shape[1] // p
        fm = fbank_mask[:, : gt * p].reshape(B, gt, p).any(-1)  # [B, gt] valid
        token_mask = fm.repeat_interleave(T // gt, dim=1)  # time-major (gt, gf) grid
        x = torch.where(token_mask[..., None], x, 0.0)

    x = x + _pos_conv(params, x)
    x = layer_norm(params["encoder_norm"], x, 1e-5)

    pos_bias = compute_position_bias(params, cfg, T)
    alpha = (2.0 * cfg.num_layers) ** 0.25 if cfg.deep_norm else 1.0
    for i in range(cfg.num_layers):
        x = _layer_forward(cfg, layer_params(params["layers"], i), x, pos_bias, token_mask, alpha)
    return x, token_mask
