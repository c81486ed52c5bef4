"""Shared functional building blocks (port of tdc_video_tpu/models/layers.py).

Modules are plain functions over parameter trees: nested dicts of tensors in
the JAX layout (weights [d_in, d_out] applied as x @ w).  int8 weights
(models/quant.py) dispatch on the "w_q" key as in JAX; LoRA adapters grafted
beside a weight ("lora_a", "lora_b": train/lora.graft_lora) add (x @ A) @ B
in `linear`, over a float or an int8 base.

Products with f32 output (`dot_f32`, JAX's preferred_element_type=float32)
run on CUDA as input-dtype GEMMs with f32 accumulation and output
(`torch.mm(..., out_dtype=float32)`); the s8 x s8 products of the int8 path
run on CUDA as `torch._int_mm` (cuBLAS).  Both are library calls: JAX
computes them outside any Pallas kernel.  On the CPU both are exact or
f32 products.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import MODEL_AXIS

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


def _int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 x [K, N] int8 -> [M, N] int32, exact.  On CUDA through
    torch._int_mm, which needs more than 16 rows and K, N multiples of 8:
    rows, K and N are padded with zeros (exact) where they fall short, e.g.
    the towers' patch embedding (K = 14 * 14 * 3 = 588).  w_q comes
    column-major from models/quant.py (cuBLAS's "TN" int8 GEMM operand
    order); a padded weight is built column-major too.  On the CPU an int32
    product (|sum| <= 127^2 K fits int32)."""
    if x_q.device.type != "cuda":
        return x_q.to(torch.int32) @ w_q.to(torch.int32)
    M, K = x_q.shape
    N = w_q.shape[1]
    Mp, Kp, Np = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
    if (Mp, Kp) != (M, K):
        x_q = F.pad(x_q, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        wp = w_q.new_zeros((Np, Kp)).t()  # column-major, as stored
        wp[:K, :N] = w_q
        w_q = wp
    y = torch._int_mm(x_q.contiguous(), w_q)
    return y[:M, :N] if (Mp, Np) != (M, N) else y


def int8_qact(x: torch.Tensor, scale: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of activations: [..., D] float -> (int8
    [..., D], f32 scale).  scale=None: dynamic per-row (per-token) scales
    from an amax; a static calibrated scalar otherwise.  One quantization
    feeds every consumer of the same activation (q/k/v share their LN
    output).  Rounds half to even, as JAX."""
    xf = x.float()
    if scale is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        x_scale = torch.clamp_min(amax / 127.0, 1e-8)
    else:
        x_scale = scale.float()
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


def int8_dot(x_q: torch.Tensor, x_scale: torch.Tensor, p: Params, out_dtype) -> torch.Tensor:
    """s8 x s8 -> s32 product with the row and column scales applied to the
    s32 result in f32; bias in out_dtype."""
    lead = x_q.shape[:-1]
    acc = _int_mm(x_q.reshape(-1, x_q.shape[-1]), p["w_q"])
    acc = acc.reshape(*lead, acc.shape[-1])
    y = acc.float() * x_scale * p["w_scale"].float()
    y = y.to(out_dtype)
    if "b" in p:
        y = y + p["b"].to(out_dtype)
    return y


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation-quantized int8 matmul (quantize + dot in one call).
    x: [..., D] float; w_q: int8 [D, F]; w_scale: f32 [F]."""
    x_q, x_scale = int8_qact(x)
    return int8_dot(x_q, x_scale, {"w_q": w_q, "w_scale": w_scale}, x.dtype)


def linear(p: Params, x: torch.Tensor, dtype=None, act_quant: bool = False) -> torch.Tensor:
    """Matmul in the activation dtype: params stored in a wider dtype are cast
    down, so bf16 activations stay bf16.

    int8 weights ("w_q", models/quant.py), two modes as in JAX:
    act_quant=False (LM decode) is weight-only: x @ w_q in x's dtype with the
    per-output-channel scale on the product (eager PyTorch converts the
    weight to x's dtype as a tensor, where XLA fuses the convert into the
    dot); act_quant=True (towers, act-quant prefill) quantizes x per row and
    runs the s8 x s8 product.  act_quant is a no-op for float weights.

    LoRA (train/lora.graft_lora): with "lora_a" [in, r] and "lora_b" [r, out]
    (B already scaled by alpha / r) beside the weight, y = x @ W + (x @ A) @ B
    as two thin products in x's dtype, then the bias; over an int8 base the
    scaled int8 product takes the place of x @ W (QLoRA)."""
    if dtype is not None:
        x = x.to(dtype)
    if "w_q" in p:
        if act_quant:
            y = int8_matmul(x, p["w_q"], p["w_scale"].float())
        else:
            y = x @ p["w_q"].to(x.dtype)
            y = y * p["w_scale"].to(y.dtype)
    else:
        y = x @ p["w"].to(x.dtype)
    if "lora_a" in p:
        y = y + (x @ p["lora_a"].to(x.dtype)) @ p["lora_b"].to(x.dtype)
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


def row_amax(x: torch.Tensor, mesh) -> torch.Tensor:
    """Per-row amax [..., 1] (f32) of an activation whose last dim is split
    over the mesh's model axis: the MAX over the axis of each rank's amax,
    which is the unsharded row's (what GSPMD computes)."""
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    return mesh.all_reduce(amax, MODEL_AXIS, op="max")


def row_parallel_linear(p: Params, x: torch.Tensor, mesh=None,
                        act_quant: bool = False) -> torch.Tensor:
    """`linear` of a weight whose input dim is split over the mesh's model
    axis (o_proj and down under tensor parallelism): each rank's product of
    its slice of x with its rows of the weight, summed over the axis, then
    the bias once.  With act_quant and int8 weights, x is quantized with
    the whole row's scale (row_amax): a rank's own amax would give another
    scale than the unsharded model's.  A weight-only int8 `w_scale` scales
    output channels, so it applies to each partial product before the sum.
    mesh None (or a model axis of 1) is `linear`."""
    if mesh is None or mesh.size(MODEL_AXIS) == 1:
        return linear(p, x, act_quant=act_quant)
    if "lora_a" in p:
        raise NotImplementedError("LoRA adapters under tensor parallelism (slice 13)")
    local = {k: v for k, v in p.items() if k != "b"}
    if act_quant and "w_q" in p:
        scale = torch.clamp_min(row_amax(x, mesh) / 127.0, 1e-8)
        y = int8_dot(*int8_qact(x, scale), local, x.dtype)
    else:
        y = linear(local, x)
    y = mesh.all_reduce(y.contiguous(), MODEL_AXIS)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def swiglu_mlp(p: Params, x: torch.Tensor, act_quant: bool = False, mesh=None) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)); under a mesh, gate and up hold this
    rank's I/n columns and down its I/n rows (row_parallel_linear)."""
    if act_quant and "w_q" in p["gate"]:
        # one shared activation quantization feeds both gate and up
        xq, xs = int8_qact(x)
        h = F.silu(int8_dot(xq, xs, p["gate"], x.dtype)) * int8_dot(xq, xs, p["up"], x.dtype)
        return row_parallel_linear(p["down"], h, mesh, act_quant=True)
    return row_parallel_linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x), mesh)


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


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [K, N] or batched [G, M, K] x [G, K, N], input-dtype operands,
    f32 accumulation and output (cuBLAS)."""
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


class _DotF32(torch.autograd.Function):
    """_mm_f32 with gradients: each backward product runs like the forward,
    the f32 cotangent cast to the operands' dtype.  `b_master`, when given,
    is the wider tensor b was cast from (same layout): b's gradient goes to
    it in its own dtype, so that callers sharing one cast of a weight
    accumulate its gradient in f32 (lm.lm_loss's chunks)."""

    @staticmethod
    def forward(ctx, a, b, b_master):
        ctx.save_for_backward(a, b)
        ctx.master_dtype = None if b_master is None else b_master.dtype
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = gm = None
        if ctx.needs_input_grad[0]:
            ga = _mm_f32(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            gw = _mm_f32(a.transpose(-1, -2), g)
            if ctx.master_dtype is not None:
                gm = gw.to(ctx.master_dtype)
            else:
                gb = gw.to(b.dtype)
        return ga, gb, gm


def dot_f32(a: torch.Tensor, b: torch.Tensor, b_master: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """a @ b with f32 output: the products of input-dtype operands summed in
    f32 (JAX's preferred_element_type=float32).  On CUDA an input-dtype GEMM
    with f32 output; no f32 copy of either operand is made.  b is [K, N]
    (a any [..., K]) or batched like a ([..., M, K] x [..., K, N], where a
    size-1 dim of b at -3, the GQA group of sdpa's keys, folds into a's
    rows).  On the CPU, and for f32 operands, the f32 product (b_master
    unused there)."""
    if a.device.type != "cuda" or a.dtype == b.dtype == torch.float32:
        return a.float() @ b.float()
    if a.dtype != b.dtype:
        raise TypeError(f"dot_f32 operands differ in dtype: {a.dtype} and {b.dtype}")
    if b.dim() == 2:
        y = _DotF32.apply(a.reshape(-1, a.shape[-1]), b, b_master)
        return y.view(*a.shape[:-1], b.shape[-1])
    if b_master is not None:
        raise ValueError("b_master is supported for a 2-D b only")
    if a.dim() == b.dim() >= 3 and b.shape[-3] == 1 and a.shape[-3] > 1:
        y = dot_f32(a.flatten(-3, -2), b.squeeze(-3))
        return y.unflatten(-2, (a.shape[-3], a.shape[-2]))
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    y = _DotF32.apply(a3, b3, None)
    return y.view(*batch, a.shape[-2], b.shape[-1])


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


def sdpa_int8kv(
    q: torch.Tensor,  # [B, T, Hq, D]
    k_q: torch.Tensor,  # [B, S, Hkv, D] int8
    k_scale: torch.Tensor,  # [B, S, Hkv] f32
    v_q: torch.Tensor,  # [B, S, Hkv, D] int8
    v_scale: torch.Tensor,  # [B, S, Hkv] f32
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, Hq, T, S]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention over an int8 KV cache without a dequantized cache: the
    per-token-per-head scales commute out of the contraction over D, so they
    apply to the scores (k) and to the softmax probs (v).  The int8 values
    are only converted to q's dtype (no scale applied)."""
    B, T, Hq, D = q.shape
    S, Hkv = k_q.shape[1], k_q.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    group = Hq // Hkv
    qg = q.reshape(B, T, Hkv, group, D).permute(0, 2, 3, 1, 4)  # b h g t d
    kt = k_q.to(q.dtype).permute(0, 2, 3, 1)[:, :, None]  # b h 1 d s
    logits = dot_f32(qg, kt)
    logits = logits * (scale * k_scale.transpose(1, 2))[:, :, None, None, :]
    if mask is not None:
        m = torch.broadcast_to(mask, (B, Hq, T, S)).reshape(B, Hkv, group, T, S)
        logits = torch.where(m, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    pv = probs * v_scale.transpose(1, 2)[:, :, None, None, :]
    vh = v_q.to(q.dtype).permute(0, 2, 1, 3)[:, :, None]  # b h 1 s d
    out = pv.to(q.dtype) @ vh  # b h g t d
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D)


def make_causal_mask(T: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    """[T, S] boolean mask; query i attends keys j <= i + offset."""
    qi = torch.arange(T, device=device)[:, None]
    kj = torch.arange(S, device=device)[None, :]
    return kj <= qi + offset
