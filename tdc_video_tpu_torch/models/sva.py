"""SVA, the Spatial Vision Aggregator (port of tdc_video_tpu/models/sva.py).

Queries [B, Nq, 1, D] attend to their windows [B, Nq, T*rf^2, D] with one
batched product per layer; this attention is plain tensor work (the JAX
package leaves it to XLA too).
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import torch

from ..config import SVAConfig
from ..device import resolve_device
from ..utils.profiling import span
from .layers import dot_f32, gelu_tanh, init_layer_norm, init_linear, layer_norm, linear, normal_init

Params = Any


def _init_ln_linear(gen, d_in, d_out, dtype, device):
    return {
        "norm": init_layer_norm(d_in, dtype, device),
        "lin": init_linear(gen, d_in, d_out, dtype, device, bias=False),
    }


def _ln_linear(p, x, eps=1e-5):
    return linear(p["lin"], layer_norm(p["norm"], x, eps))


def _init_layer(gen, cfg: SVAConfig, rf_list: Sequence[int], dtype, device):
    d = cfg.vision_hidden_size
    p = {
        "proj_context": init_linear(gen, d, d, dtype, device, bias=False),
        "proj_in": init_linear(gen, 2 * d, d, dtype, device, bias=False),
        "q_proj": _init_ln_linear(gen, d, d, dtype, device),
        "o_proj": init_linear(gen, d, d, dtype, device, bias=False),
        "norm": init_layer_norm(d, dtype, device),
        "proj_out": {
            "fc1": init_linear(gen, d, d, dtype, device, bias=False),
            "fc2": init_linear(gen, d, d, dtype, device, bias=False),
        },
        "kv": [],
        "pos_embed": [],
    }
    for rf in rf_list:
        p["kv"].append({
            "k_proj": _init_ln_linear(gen, d, d, dtype, device),
            "v_proj": _init_ln_linear(gen, d, d, dtype, device),
        })
        p["pos_embed"].append(normal_init(gen, (rf * rf, d), dtype, device) if rf > 1 else None)
    return p


def init_sva(cfg: SVAConfig, tower_dims: Sequence[int], llm_hidden: int,
             gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    """Aux projectors, per-group samplers, vision_query and mm_projector."""
    device = resolve_device(device)
    d = cfg.vision_hidden_size
    params: dict = {"aux_projectors": [], "samplers": []}
    for td in tower_dims:
        params["aux_projectors"].append({
            "fc1": init_linear(gen, td, d, dtype, device),
            "fc2": init_linear(gen, d, d, dtype, device),
            "norm": init_layer_norm(d, dtype, device),
        })
    for g in range(cfg.num_query_group):
        rf_list = [int(tl**0.5) // int(cfg.query_num_list[g] ** 0.5)
                   for tl in cfg.tower_token_len_list]
        params["samplers"].append({"layers": [
            _init_layer(gen, cfg, rf_list, dtype, device) for _ in range(cfg.connector_depth)
        ]})
    params["vision_query"] = normal_init(gen, (cfg.num_query_group, d), dtype, device)
    params["mm_projector"] = {
        "fc1": init_linear(gen, d * cfg.num_query_group, llm_hidden, dtype, device),
        "fc2": init_linear(gen, llm_hidden, llm_hidden, dtype, device),
    }
    return params


def aux_project(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """Per-tower projector: Linear-GELU-Linear-LayerNorm."""
    h = gelu_tanh(linear(p["fc1"], feats))
    return layer_norm(p["norm"], linear(p["fc2"], h))


def mm_project(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """Final projector: Linear-GELU-Linear into the LLM space."""
    return linear(p["fc2"], gelu_tanh(linear(p["fc1"], feats)))


def rearrange_windows(feats: torch.Tensor, query_side: int) -> torch.Tensor:
    """[B, S*S, D] tower grid -> [B, Nq, rf^2, D] per-query-location windows."""
    B, N, D = feats.shape
    side = int(N**0.5)
    rf = side // query_side
    x = feats.reshape(B, query_side, rf, query_side, rf, D).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, query_side * query_side, rf * rf, D)


def _sampler_layer(
    cfg: SVAConfig,
    p: Params,
    queries: torch.Tensor,  # [B, Nq, 1, D]
    context: torch.Tensor,  # [B, 1, D]
    windows: List[torch.Tensor],  # per tower [B, Nq, rf^2, D]
    masks: Optional[List[Optional[torch.Tensor]]],  # per tower [B, Nq, rf^2] bool
) -> torch.Tensor:
    B, Nq, _, D = queries.shape
    nh = cfg.num_heads
    hd = D // nh

    residual = queries
    ctx = linear(p["proj_context"], context)[:, None].expand(B, Nq, 1, D)
    q = linear(p["proj_in"], torch.cat([queries, ctx], dim=-1))  # [B, Nq, 1, D]

    qh = _ln_linear(p["q_proj"], q).reshape(B, Nq, 1, nh, hd)
    ks, vs, ms = [], [], []
    for i, w in enumerate(windows):
        wp = w
        if p["pos_embed"][i] is not None:
            wp = w + p["pos_embed"][i].to(w.dtype)[None, None]
        ks.append(_ln_linear(p["kv"][i]["k_proj"], wp))
        vs.append(_ln_linear(p["kv"][i]["v_proj"], wp))
        if masks is not None and masks[i] is not None:
            ms.append(masks[i])
        else:
            ms.append(torch.ones(w.shape[:3], dtype=torch.bool, device=w.device))
    k = torch.cat(ks, dim=2).reshape(B, Nq, -1, nh, hd)
    v = torch.cat(vs, dim=2).reshape(B, Nq, -1, nh, hd)
    m = torch.cat(ms, dim=2)  # [B, Nq, Skv]

    scale = 1.0 / math.sqrt(hd)
    # bnqhd,bnshd->bnhqs with f32 logits
    logits = dot_f32(qh.permute(0, 1, 3, 2, 4), k.permute(0, 1, 3, 4, 2)) * scale
    logits = torch.where(m[:, :, None, None, :], logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    attn = probs.to(v.dtype) @ v.permute(0, 1, 3, 2, 4)  # b n h q d
    attn = linear(p["o_proj"], attn.permute(0, 1, 3, 2, 4).reshape(B, Nq, 1, D))

    q = layer_norm(p["norm"], q + attn, 1e-5)
    q = linear(p["proj_out"]["fc2"], gelu_tanh(linear(p["proj_out"]["fc1"], q)))
    return q + residual


def sampler_forward(cfg: SVAConfig, p: Params, queries, context, windows, masks=None):
    q = queries[:, :, None, :]
    for layer in p["layers"]:
        q = _sampler_layer(cfg, layer, q, context, windows, masks)
    return q[:, :, 0, :]


def sva_forward(
    cfg: SVAConfig,
    params: Params,
    tower_feats: List[torch.Tensor],  # per tower [B, 576, C_tower]
    masks: Optional[List[Optional[torch.Tensor]]] = None,
) -> torch.Tensor:
    """Project towers, build the query grid, run the sampler groups, concat,
    project to the LLM hidden size.  Returns [B, image_token_len, llm_hidden]."""
    with span("encode.sva", device=True, frames=tower_feats[0].shape[0]):
        return _sva_forward(cfg, params, tower_feats, masks)


def _sva_forward(cfg: SVAConfig, params: Params, tower_feats: List[torch.Tensor],
                 masks: Optional[List[Optional[torch.Tensor]]]) -> torch.Tensor:
    projected = [aux_project(params["aux_projectors"][i], f) for i, f in enumerate(tower_feats)]
    B = projected[0].shape[0]
    context = projected[0].mean(dim=1, keepdim=True)  # [B, 1, D]

    group_outputs = []
    for g in range(cfg.num_query_group):
        nq = cfg.query_num_list[g]
        side = int(nq**0.5)
        queries = params["vision_query"][g][None, None].expand(B, nq, cfg.vision_hidden_size)
        queries = queries.to(projected[0].dtype)
        windows = [rearrange_windows(f, side) for f in projected]
        win_masks = None
        if masks is not None:
            win_masks = [
                rearrange_windows(m[..., None].float(), side)[..., 0] > 0.5 if m is not None else None
                for m in masks
            ]
        out = sampler_forward(cfg, params["samplers"][g], queries, context, windows, win_masks)
        if side != cfg.final_side_len:
            from .vit import bilinear_resize_tokens

            out = bilinear_resize_tokens(out, side, cfg.final_side_len)
        group_outputs.append(out)
    return mm_project(params["mm_projector"], torch.cat(group_outputs, dim=-1))
