"""Shared functional building blocks (port of tdc_video_tpu/models/layers.py).

Modules are plain functions over parameter trees: nested dicts of tensors in
the JAX layout (weights [d_in, d_out] applied as x @ w).  Only the float
paths are ported; the int8 and LoRA branches of `linear` are not.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Any


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX initializers; not the same bits)
# ---------------------------------------------------------------------------


def normal_init(gen: torch.Generator, shape, dtype, device, stddev: float = 0.02) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * stddev).to(dtype)


def lecun_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else max(1, shape[-1])
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x / math.sqrt(fan_in)).to(dtype)


def init_linear(gen, d_in, d_out, dtype, device, bias=True, stddev=None) -> Params:
    w = (
        normal_init(gen, (d_in, d_out), dtype, device, stddev)
        if stddev is not None
        else lecun_init(gen, (d_in, d_out), dtype, device)
    )
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def init_layer_norm(d, dtype, device) -> Params:
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def init_rms_norm(d, dtype, device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Linear / norms / MLPs
# ---------------------------------------------------------------------------


def linear(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Matmul in the activation dtype: params stored in a wider dtype are cast
    down, so bf16 activations stay bf16 (float branch of the JAX `linear`)."""
    if dtype is not None:
        x = x.to(dtype)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.square(xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p: Params, x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    h = linear(p["fc1"], x)
    h = F.gelu(h, approximate="tanh" if approximate else "none")
    return linear(p["fc2"], h)


def swiglu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_inv_freq(
    head_dim: int,
    theta: float,
    scaling: Optional[Tuple[float, float, float, int]] = None,
    device=None,
) -> torch.Tensor:
    """Inverse frequencies, with optional Llama-3-style NTK-by-parts scaling."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / (theta ** exps)
    if scaling is not None:
        factor, low_ff, high_ff, orig_ctx = scaling
        low_wl = orig_ctx / low_ff
        high_wl = orig_ctx / high_ff
        wl = 2.0 * math.pi / inv
        smooth = ((orig_ctx / wl - low_ff) / (high_ff - low_ff)).clamp(0.0, 1.0)
        inv = torch.where(
            wl > low_wl,
            inv / factor,
            torch.where(wl < high_wl, inv, (1 - smooth) * inv / factor + smooth * inv),
        )
    return inv


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions [*, T] -> cos/sin [*, T, head_dim] (half-rotation layout)."""
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, H, D]; cos/sin [..., T, D] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain path; the CUDA kernels live in ops/flash_attention.py and
# are dispatched by models/attention.py)
# ---------------------------------------------------------------------------


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 output: the products of input-dtype operands summed in
    f32 (JAX's preferred_element_type=float32)."""
    return a.float() @ b.float()


def sdpa(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, Hq, T, S], True = keep
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query scaled dot-product attention with f32 softmax: f32 logits
    with the scale applied after the dot, finfo(f32).min masking."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    qg = q.reshape(B, T, Hkv, group, D).permute(0, 2, 3, 1, 4)  # b h g t d
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # b h 1 d s
    logits = dot_f32(qg, kt) * scale  # b h g t s
    if mask is not None:
        m = torch.broadcast_to(mask, (B, Hq, T, S)).reshape(B, Hkv, group, T, S)
        logits = torch.where(m, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    vh = v.permute(0, 2, 1, 3)[:, :, None]  # b h 1 s d
    out = probs.to(v.dtype) @ vh  # b h g t d
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D)


def make_causal_mask(T: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    """[T, S] boolean mask; query i attends keys j <= i + offset."""
    qi = torch.arange(T, device=device)[:, None]
    kj = torch.arange(S, device=device)[None, :]
    return kj <= qi + offset
