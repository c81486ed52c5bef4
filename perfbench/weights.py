"""Seeded random weights in the port's parameter layout, made on the device in
a few large calls.

`spec(cfg)` lays out every leaf as (kind, shape, std): "n" normal with that
std, "z" zeros, "o" ones, with the distributions the model's initialisers
use (LeCun normal for a linear weight, 0.02 for embeddings and queries).
`make` fills one flat buffer per (kind, std) with a single generator call and
hands out views of it, so the whole 9.5 B-parameter tree costs some twenty
kernel launches.  The same seed gives the same bits.

The decoder's tree comes from its family (perfbench/lm/<name>.py, `spec`),
which builds it from `lin`, `ln`, `normal` and `stack` here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import core

Leaf = Tuple[str, Tuple[int, ...], float]


def lin(d_in: int, d_out: int, bias: bool = True) -> dict:
    """A linear layer: LeCun-normal weight [d_in, d_out], zero bias."""
    p = {"w": ("n", (d_in, d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = ("z", (d_out,), 0.0)
    return p


def ln(d: int) -> dict:
    """A LayerNorm: unit scale, zero bias."""
    return {"scale": ("o", (d,), 0.0), "bias": ("z", (d,), 0.0)}


def normal(*shape, std: float = 0.02) -> Leaf:
    """A table or query drawn normal(0, std)."""
    return ("n", tuple(shape), std)


def stack(n: int, tree):
    """A layer tree with every leaf stacked n deep on axis 0."""
    if isinstance(tree, dict):
        return {k: stack(n, v) for k, v in tree.items()}
    kind, shape, std = tree
    return (kind, (n,) + shape, std)


def _vit(vc) -> dict:
    d, f = vc.hidden_size, vc.intermediate_size
    lay = {"norm1": ln(d), "q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d),
           "o_proj": lin(d, d), "norm2": ln(d)}
    lay["mlp"] = ({"gate_up": lin(d, 2 * f), "down": lin(f, d)} if vc.use_swiglu
                  else {"fc1": lin(d, f), "fc2": lin(f, d)})
    if vc.layerscale:
        lay["ls1"] = ("o", (d,), 0.0)
        lay["ls2"] = ("o", (d,), 0.0)
    g = vc.image_size // vc.patch_size
    p = {"patch_embed": lin(vc.patch_size ** 2 * 3, d),
         "pos_embed": normal(g * g + (1 if vc.use_cls_token else 0), d),
         "layers": stack(vc.num_layers, lay), "final_norm": ln(d)}
    if vc.use_cls_token:
        p["cls_token"] = normal(d)
    return p


def _sva(sc, tower_dims, H: int) -> dict:
    d = sc.vision_hidden_size

    def ln_lin():
        return {"norm": ln(d), "lin": lin(d, d, False)}

    samplers = []
    for g in range(sc.num_query_group):
        rfs = [int(t ** 0.5) // int(sc.query_num_list[g] ** 0.5) for t in sc.tower_token_len_list]
        layers = [{"proj_context": lin(d, d, False), "proj_in": lin(2 * d, d, False),
                   "q_proj": ln_lin(), "o_proj": lin(d, d, False), "norm": ln(d),
                   "proj_out": {"fc1": lin(d, d, False), "fc2": lin(d, d, False)},
                   "kv": [{"k_proj": ln_lin(), "v_proj": ln_lin()} for _ in rfs],
                   "pos_embed": [normal(rf * rf, d) if rf > 1 else None for rf in rfs]}
                  for _ in range(sc.connector_depth)]
        samplers.append({"layers": layers})
    return {"aux_projectors": [{"fc1": lin(td, d), "fc2": lin(d, d), "norm": ln(d)}
                               for td in tower_dims],
            "samplers": samplers,
            "vision_query": normal(sc.num_query_group, d),
            "mm_projector": {"fc1": lin(d * sc.num_query_group, H), "fc2": lin(H, H)}}


def _compressor(cfg) -> dict:
    q, H = cfg.qformer, cfg.lm.hidden_size
    d = q.hidden_size

    def attn(kv):
        return {"q_proj": lin(d, d), "k_proj": lin(kv, d), "v_proj": lin(kv, d),
                "o_proj": lin(d, d), "norm": ln(d)}

    def ffn():
        return {"fc1": lin(d, q.intermediate_size), "fc2": lin(q.intermediate_size, d), "norm": ln(d)}

    layers = [{"self_attn": attn(d),
               "cross_attn": attn(q.encoder_width) if i % q.cross_attention_freq == 0 else None,
               "ffn": ffn(), "ffn_query": ffn()} for i in range(q.num_layers)]
    return {"qformer": {"embeddings": {"word": normal(q.vocab_size, d),
                                       "position": normal(q.max_position_embeddings, d),
                                       "norm": ln(d)},
                        "layers": layers},
            "query_proj": lin(H, d), "vision_proj": lin(d, H),
            "query_tokens": normal(cfg.compression.context_token_num, d),
            "frame_seg": normal(H, std=1.0)}


def _beats(bc) -> dict:
    d, e = bc.encoder_embed_dim, bc.embed_dim
    lay = {"q_proj": lin(d, d), "k_proj": lin(d, d), "v_proj": lin(d, d), "o_proj": lin(d, d),
           "attn_norm": ln(d), "fc1": lin(d, bc.ffn_dim), "fc2": lin(bc.ffn_dim, d),
           "final_norm": ln(d), "grep_linear": lin(d // bc.num_heads, 8),
           "grep_a": ("o", (bc.num_heads,), 0.0)}
    p = {"patch_embed": {"w": normal(bc.patch_size ** 2, e)},
         "patch_norm": ln(e), "post_extract_proj": lin(e, d),
         "pos_conv": {"w": normal(d, d // 16, 128, std=math.sqrt(4.0 / (128 * d))),
                      "b": ("z", (d,), 0.0)},
         "encoder_norm": ln(d),
         "rel_pos_bias": normal(bc.num_buckets, bc.num_heads),
         "layers": stack(bc.num_layers, lay)}
    if bc.conv_bias:
        p["patch_embed"]["b"] = ("z", (e,), 0.0)
    return p


def spec(cfg) -> dict:
    """The parameter tree of a TDC-Video model (cfg: the configuration's
    `model` section as a namespace), every leaf a (kind, shape, std)."""
    H = cfg.lm.hidden_size
    p = {"siglip": _vit(cfg.siglip), "dino": _vit(cfg.dino),
         "sva": _sva(cfg.sva, (cfg.siglip.hidden_size, cfg.dino.hidden_size), H),
         "compressor": _compressor(cfg), "lm": core.lm_family(cfg).spec(cfg.lm),
         "image_newline": normal(H)}
    if cfg.audio_input:
        p["beats"] = _beats(cfg.beats)
        p["audio_proj"] = lin(cfg.beats.encoder_embed_dim, H)
    return p


def _leaves(tree, out: List):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def make(tree, seed: int, device, dtype=torch.bfloat16):
    """The tensors of a spec tree: one buffer per (kind, std), filled by one
    call on a generator seeded with `seed` on `device`, cut into views."""
    groups: Dict[Tuple[str, float], int] = {}
    for kind, shape, std in _leaves(tree, []):
        groups[(kind, std)] = groups.get((kind, std), 0) + math.prod(shape)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    bufs, offs = {}, {}
    for key in sorted(groups):
        kind, std = key
        if kind == "n":
            b = torch.empty(groups[key], dtype=dtype, device=device).normal_(0.0, std, generator=gen)
        else:
            b = (torch.zeros if kind == "z" else torch.ones)(groups[key], dtype=dtype, device=device)
        bufs[key], offs[key] = b, 0

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        if t is None:
            return None
        kind, shape, std = t
        n, o = math.prod(shape), offs[(kind, std)]
        offs[(kind, std)] = o + n
        return bufs[(kind, std)][o:o + n].view(shape)

    return build(tree)
