"""Int8 quantization for serving (port of tdc_video_tpu/models/quant.py).

Two uses, as in JAX:
* the LM, weight-only (`quantize_lm_int8`): symmetric per-output-channel
  int8 weights, the product run in the activation dtype with the channel
  scale on its output (models/layers.linear);
* the towers (`quantize_vit_int8`): the same weights, with the activations
  quantized per token (dynamic) or by calibrated per-layer scales (static,
  `calibrate_vit_act_scales`), and the product run s8 x s8
  (models/layers.int8_dot).

Rounding is half to even in both packages, so `w_q` equals JAX's bit for
bit.  `w_q` is stored column-major (a [in, out] tensor with strides (1, in),
per layer for stacked [L, in, out] leaves): JAX's values and logical
layout, in the "TN" operand order of cuBLAS's int8 GEMMs (layers._int_mm).

    params["lm"] = quantize_lm_int8(params["lm"])
    # layers.linear dispatches on the "w_q" key; call sites are unchanged.
"""

from __future__ import annotations

from typing import Any

import torch

Params = Any


def _col_major(w: torch.Tensor) -> torch.Tensor:
    """The same [..., in, out] values with the last two dims in column-major
    memory order."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def _quantize_w(w: torch.Tensor) -> Params:
    """[..., in, out] float -> {"w_q": int8, "w_scale": f32 [..., out]}: one
    scale per output channel (per layer for stacked leaves)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    w_q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"w_q": _col_major(w_q), "w_scale": scale}


def quantize_linear_int8(p: Params) -> Params:
    """{"w": [in, out], "b"?} -> {"w_q": int8, "w_scale": [out], "b"?}."""
    out = _quantize_w(p["w"])
    if "b" in p:
        out["b"] = p["b"]
    return out


def _is_linear(p) -> bool:
    return isinstance(p, dict) and "w" in p and p["w"].dim() >= 2


def quantize_tree_int8(params: Params, skip=()) -> Params:
    """Quantize every linear in a module tree (stacked-layer [L, in, out]
    leaves keep their leading axis; scales follow).  `skip` names top-level
    subtrees left untouched.  The caller's float tree stays as it is; the
    f32 temporaries of the quantization are one leaf's at a time."""

    def rec(tree, top):
        if _is_linear(tree) and top not in skip:
            return quantize_linear_int8(tree)
        if isinstance(tree, dict):
            return {k: rec(v, k if top is None else top) for k, v in tree.items()}
        return tree

    return rec(params, None)


def quantize_lm_int8(lm_params: Params, include_head: bool = True) -> Params:
    """LM projections -> weight-only int8.  The embedding table stays float:
    it is gathered, not streamed, per token."""
    skip = ("embed",) if include_head else ("embed", "lm_head")
    return quantize_tree_int8(lm_params, skip=skip)


def quantize_vit_int8(vit_params: Params, act_scales: Params = None) -> Params:
    """ViT tower -> int8 weights for the s8 x s8 product; LayerNorm, softmax,
    LayerScale and the position table stay float.  act_scales=None:
    activations quantized per token; a tree from calibrate_vit_act_scales:
    static per-layer scales, carried as layers["act_scale"]."""
    out = quantize_tree_int8(vit_params)
    if act_scales is not None:
        out["layers"] = dict(out["layers"],
                             act_scale={k: v.float() for k, v in act_scales.items()})
    return out


@torch.no_grad()
def calibrate_vit_act_scales(cfg, vit_params: Params, pixels: torch.Tensor,
                             attn_impl: str = "xla", dtype=torch.bfloat16,
                             margin: float = 1.05) -> Params:
    """Static W8A8 calibration: run the float tower on a representative pixel
    batch, take each layer's activation amax at each quantization site, and
    derive symmetric int8 scales ({"qkv", "attn", "mlp", "down"}: f32 [L]).
    `margin` leaves headroom for tokens slightly outside the calibration
    range (beyond it values clip at +-127)."""
    from .vit import vit_forward

    _, stats = vit_forward(cfg, vit_params, pixels, interpolate=False, attn_impl=attn_impl,
                           dtype=dtype, calibrate=True)
    return {k: torch.clamp_min(v.float() * margin / 127.0, 1e-8) for k, v in stats.items()}


def dequantize_linear(p: Params, dtype=torch.float32) -> Params:
    """Inverse (tests / export): w = w_q * scale."""
    w = p["w_q"].float() * p["w_scale"][..., None, :]
    out = {"w": w.to(dtype)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dequantize_tree_int8(params: Params, dtype=torch.float32) -> Params:
    """Every int8 linear of a tree back to float ({"w_q", "w_scale"} ->
    {"w"}); other leaves (act_scale tables, norms, embeddings) pass
    through."""

    def rec(tree):
        if isinstance(tree, dict):
            if "w_q" in tree:
                out = dequantize_linear(tree, dtype=dtype)
                for k, v in tree.items():
                    if k not in ("w_q", "w_scale", "b"):
                        out[k] = v
                return out
            return {k: rec(v) for k, v in tree.items()}
        return tree

    return rec(params)
