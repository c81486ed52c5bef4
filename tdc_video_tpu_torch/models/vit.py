"""ViT encoder serving the SigLIP and DINOv2 towers (port of
tdc_video_tpu/models/vit.py).

The patch conv is one matmul over flattened patches; frames are the batch
axis; layers run in a Python loop.  Each layer's attention goes through
models/attention.py, which on the card launches K2 (DINOv2, D=64) or K3
(SigLIP, D=72) on the packed [B, N, H*D] projections in place.

int8 towers (models/quant.quantize_vit_int8): the projections run s8 x s8
with activations quantized per token, or by the static per-layer scales a
calibrated tree carries (layers["act_scale"]); attention, LayerNorm and
LayerScale stay float, so K2 and K3 still run.  calibrate=True (float
weights) also returns each layer's activation amax per site.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import ViTConfig
from ..device import resolve_device
from .attention import attention
from .layers import (
    gelu_tanh,
    init_layer_norm,
    init_linear,
    int8_dot,
    int8_qact,
    layer_norm,
    linear,
    normal_init,
)

Params = Any


def _init_layer(gen, cfg: ViTConfig, dtype, device):
    d, f = cfg.hidden_size, cfg.intermediate_size
    p = {
        "norm1": init_layer_norm(d, dtype, device),
        "q_proj": init_linear(gen, d, d, dtype, device),
        "k_proj": init_linear(gen, d, d, dtype, device),
        "v_proj": init_linear(gen, d, d, dtype, device),
        "o_proj": init_linear(gen, d, d, dtype, device),
        "norm2": init_layer_norm(d, dtype, device),
    }
    if cfg.use_swiglu:
        p["mlp"] = {
            "gate_up": init_linear(gen, d, 2 * f, dtype, device),
            "down": init_linear(gen, f, d, dtype, device),
        }
    else:
        p["mlp"] = {
            "fc1": init_linear(gen, d, f, dtype, device),
            "fc2": init_linear(gen, f, d, dtype, device),
        }
    if cfg.layerscale:
        p["ls1"] = torch.ones((d,), dtype=dtype, device=device)
        p["ls2"] = torch.ones((d,), dtype=dtype, device=device)
    return p


def init_vit(cfg: ViTConfig, gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    from .lm import _stack

    device = resolve_device(device)
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    n_pos = cfg.num_patches + (1 if cfg.use_cls_token else 0)
    params = {
        "patch_embed": init_linear(gen, patch_dim, cfg.hidden_size, dtype, device),
        "pos_embed": normal_init(gen, (n_pos, cfg.hidden_size), dtype, device),
        "layers": _stack([_init_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)]),
        "final_norm": init_layer_norm(cfg.hidden_size, dtype, device),
    }
    if cfg.use_cls_token:
        params["cls_token"] = normal_init(gen, (cfg.hidden_size,), dtype, device)
    return params


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, P*P*3] with (ph, pw, c) minor order; trailing
    pixels past the last whole patch are dropped (stride-`patch` valid conv)."""
    B, H, W, C = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels[:, : gh * patch, : gw * patch].reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


@lru_cache(maxsize=32)
def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of jax.image.resize(method="linear",
    antialias=False) along one axis (triangle kernel, half-pixel centres,
    rows normalised, samples outside the input zeroed)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(0.0, 1.0 - x).astype(np.float32)  # [n_in, n_out]
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps, w / np.where(tot != 0, tot, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def bilinear_resize_tokens(tokens: torch.Tensor, src_side: int, dst_side: int) -> torch.Tensor:
    """[B, src*src, C] -> [B, dst*dst, C], matching
    jax.image.resize(method="linear", antialias=False).  Computed in f32."""
    if src_side == dst_side:
        return tokens
    B, N, C = tokens.shape
    x = tokens.reshape(B, src_side, src_side, C).float()
    w = torch.from_numpy(_linear_resize_matrix(src_side, dst_side)).to(x.device)
    out = torch.einsum("ih,bhwc,jw->bijc", w, x, w)
    return out.reshape(B, dst_side * dst_side, C).to(tokens.dtype)


def _layer_forward(cfg: ViTConfig, p: Params, x: torch.Tensor, attn_impl: str,
                   stats: Optional[Dict[str, list]] = None) -> torch.Tensor:
    """One layer; `stats`, when given, gets this layer's activation amax at
    each quantization site appended (calibration)."""
    B, N, D = x.shape
    nh = cfg.num_heads
    hd = D // nh
    int8 = "w_q" in p["q_proj"]
    asc = p.get("act_scale") if int8 else None

    def quantize(xx, site):
        return int8_qact(xx, None if asc is None else asc[site])

    def qlin(pp, xx, site):
        if "w_q" in pp:
            return int8_dot(*quantize(xx, site), pp, x.dtype)
        return linear(pp, xx)

    def record(site, t):
        if stats is not None:
            stats[site].append(t.float().abs().amax())

    h = layer_norm(p["norm1"], x, cfg.layer_norm_eps)
    record("qkv", h)
    if int8:  # one quantization of the LN output feeds q, k and v
        hq, hs = quantize(h, "qkv")
        q, k, v = (int8_dot(hq, hs, p[n], x.dtype) for n in ("q_proj", "k_proj", "v_proj"))
    else:
        q, k, v = (linear(p[n], h) for n in ("q_proj", "k_proj", "v_proj"))
    q, k, v = (t.reshape(B, N, nh, hd) for t in (q, k, v))
    a = attention(q, k, v, impl=attn_impl).reshape(B, N, D)
    record("attn", a)
    a = qlin(p["o_proj"], a, "attn")
    if cfg.layerscale:
        a = a * p["ls1"].to(a.dtype)
    x = x + a

    h = layer_norm(p["norm2"], x, cfg.layer_norm_eps)
    record("mlp", h)
    if cfg.use_swiglu:
        # one gate_up product split in two: the same values as JAX's two
        # sliced int8 dots (per-column scales, exact s32 sums)
        g, u = qlin(p["mlp"]["gate_up"], h, "mlp").chunk(2, dim=-1)
        inner = torch.nn.functional.silu(g) * u
    else:
        inner = gelu_tanh(qlin(p["mlp"]["fc1"], h, "mlp"))
    record("down", inner)
    m = qlin(p["mlp"]["down"] if cfg.use_swiglu else p["mlp"]["fc2"], inner, "down")
    if cfg.layerscale:
        m = m * p["ls2"].to(m.dtype)
    return x + m


def vit_forward(
    cfg: ViTConfig,
    params: Params,
    pixels: torch.Tensor,  # [B, H, W, 3] normalized
    interpolate: bool = True,
    attn_impl: str = "xla",
    dtype=torch.float32,
    calibrate: bool = False,
):
    """Returns patch features [B, N (or interp_tokens), C]; CLS dropped.
    calibrate=True (float weights) returns (features, stats) with stats
    {"qkv", "attn", "mlp", "down"}: [L] per-layer activation amaxes, the
    input of models/quant.calibrate_vit_act_scales."""
    from .lm import layer_params

    x = patchify(pixels.to(dtype), cfg.patch_size)
    x = linear(params["patch_embed"], x, act_quant=True)
    B = x.shape[0]
    if cfg.use_cls_token:
        cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)[None]
    stats = {k: [] for k in ("qkv", "attn", "mlp", "down")} if calibrate else None
    for i in range(cfg.num_layers):
        x = _layer_forward(cfg, layer_params(params["layers"], i), x, attn_impl, stats)
    # both HF towers layer-norm the sequence output
    x = layer_norm(params["final_norm"], x, cfg.layer_norm_eps)
    if cfg.use_cls_token:
        x = x[:, 1:]
    if interpolate:
        x = bilinear_resize_tokens(x, cfg.grid_size, int(cfg.interp_tokens**0.5))
    if calibrate:
        return x, {k: torch.stack(v) for k, v in stats.items()}
    return x


def prepare_pos_embed(params: Params, cfg: ViTConfig) -> Params:
    """Resize a checkpoint's position grid to this config's grid size (DINOv2
    ships a 518-px table, a 37x37 grid; the model runs at 378 px, 27x27).
    As jax.image.resize(method="cubic", antialias=False) in f32: Keys cubic
    with a = -0.5, the kernel not widened when downsampling."""
    from ..data.images import cubic_resize_matrix

    pos = params["pos_embed"]
    n_extra = 1 if cfg.use_cls_token else 0
    if pos.shape[0] == cfg.num_patches + n_extra:
        return params
    grid = pos[n_extra:]
    src, dst = int(grid.shape[0] ** 0.5), cfg.grid_size
    g = grid.reshape(src, src, -1).float()
    w = torch.from_numpy(cubic_resize_matrix(src, dst, antialias=False)).to(g.device)
    g = torch.einsum("ih,hwc,jw->ijc", w, g, w).reshape(dst * dst, -1).to(pos.dtype)
    return dict(params, pos_embed=torch.cat([pos[:n_extra], g], dim=0))
