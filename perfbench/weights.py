"""Seeded random weights in the port's parameter layout, made on the device in
a few large calls.

`spec(cfg)` lays out every leaf as (kind, shape, std): "n" normal with that
std, "z" zeros, "o" ones, with the distributions the model's initialisers
use (LeCun normal for a linear weight, 0.02 for embeddings and queries).
`make` fills one flat buffer per (kind, std) with a single generator call and
hands out views of it, so the whole 9.5 B-parameter tree costs some twenty
kernel launches.  The same seed gives the same bits.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], float]


def _lin(d_in: int, d_out: int, bias: bool = True) -> dict:
    p = {"w": ("n", (d_in, d_out), 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = ("z", (d_out,), 0.0)
    return p


def _ln(d: int) -> dict:
    return {"scale": ("o", (d,), 0.0), "bias": ("z", (d,), 0.0)}


def _normal(*shape, std: float = 0.02) -> Leaf:
    return ("n", tuple(shape), std)


def _stack(n: int, tree):
    """A layer tree with every leaf stacked n deep on axis 0."""
    if isinstance(tree, dict):
        return {k: _stack(n, v) for k, v in tree.items()}
    kind, shape, std = tree
    return (kind, (n,) + shape, std)


def _vit(vc) -> dict:
    d, f = vc.hidden_size, vc.intermediate_size
    lay = {"norm1": _ln(d), "q_proj": _lin(d, d), "k_proj": _lin(d, d), "v_proj": _lin(d, d),
           "o_proj": _lin(d, d), "norm2": _ln(d)}
    lay["mlp"] = ({"gate_up": _lin(d, 2 * f), "down": _lin(f, d)} if vc.use_swiglu
                  else {"fc1": _lin(d, f), "fc2": _lin(f, d)})
    if vc.layerscale:
        lay["ls1"] = ("o", (d,), 0.0)
        lay["ls2"] = ("o", (d,), 0.0)
    g = vc.image_size // vc.patch_size
    p = {"patch_embed": _lin(vc.patch_size ** 2 * 3, d),
         "pos_embed": _normal(g * g + (1 if vc.use_cls_token else 0), d),
         "layers": _stack(vc.num_layers, lay), "final_norm": _ln(d)}
    if vc.use_cls_token:
        p["cls_token"] = _normal(d)
    return p


def _sva(sc, tower_dims, H: int) -> dict:
    d = sc.vision_hidden_size

    def ln_lin():
        return {"norm": _ln(d), "lin": _lin(d, d, False)}

    samplers = []
    for g in range(sc.num_query_group):
        rfs = [int(t ** 0.5) // int(sc.query_num_list[g] ** 0.5) for t in sc.tower_token_len_list]
        layers = [{"proj_context": _lin(d, d, False), "proj_in": _lin(2 * d, d, False),
                   "q_proj": ln_lin(), "o_proj": _lin(d, d, False), "norm": _ln(d),
                   "proj_out": {"fc1": _lin(d, d, False), "fc2": _lin(d, d, False)},
                   "kv": [{"k_proj": ln_lin(), "v_proj": ln_lin()} for _ in rfs],
                   "pos_embed": [_normal(rf * rf, d) if rf > 1 else None for rf in rfs]}
                  for _ in range(sc.connector_depth)]
        samplers.append({"layers": layers})
    return {"aux_projectors": [{"fc1": _lin(td, d), "fc2": _lin(d, d), "norm": _ln(d)}
                               for td in tower_dims],
            "samplers": samplers,
            "vision_query": _normal(sc.num_query_group, d),
            "mm_projector": {"fc1": _lin(d * sc.num_query_group, H), "fc2": _lin(H, H)}}


def _compressor(cfg) -> dict:
    q, H = cfg.qformer, cfg.lm.hidden_size
    d = q.hidden_size

    def attn(kv):
        return {"q_proj": _lin(d, d), "k_proj": _lin(kv, d), "v_proj": _lin(kv, d),
                "o_proj": _lin(d, d), "norm": _ln(d)}

    def ffn():
        return {"fc1": _lin(d, q.intermediate_size), "fc2": _lin(q.intermediate_size, d), "norm": _ln(d)}

    layers = [{"self_attn": attn(d),
               "cross_attn": attn(q.encoder_width) if i % q.cross_attention_freq == 0 else None,
               "ffn": ffn(), "ffn_query": ffn()} for i in range(q.num_layers)]
    return {"qformer": {"embeddings": {"word": _normal(q.vocab_size, d),
                                       "position": _normal(q.max_position_embeddings, d),
                                       "norm": _ln(d)},
                        "layers": layers},
            "query_proj": _lin(H, d), "vision_proj": _lin(d, H),
            "query_tokens": _normal(cfg.compression.context_token_num, d),
            "frame_seg": _normal(H, std=1.0)}


def _lm(lc) -> dict:
    H, Fd = lc.hidden_size, lc.intermediate_size
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    b = lc.attention_bias
    lay = {"input_norm": {"scale": ("o", (H,), 0.0)}, "q_proj": _lin(H, qd, b),
           "k_proj": _lin(H, kvd, b), "v_proj": _lin(H, kvd, b), "o_proj": _lin(qd, H, False),
           "post_attn_norm": {"scale": ("o", (H,), 0.0)},
           "mlp": {"gate": _lin(H, Fd, False), "up": _lin(H, Fd, False), "down": _lin(Fd, H, False)}}
    p = {"embed": {"embedding": _normal(lc.vocab_size, H)},
         "layers": _stack(lc.num_layers, lay), "final_norm": {"scale": ("o", (H,), 0.0)}}
    if not lc.tie_word_embeddings:
        p["lm_head"] = _lin(H, lc.vocab_size, False)
    return p


def _beats(bc) -> dict:
    d, e = bc.encoder_embed_dim, bc.embed_dim
    lay = {"q_proj": _lin(d, d), "k_proj": _lin(d, d), "v_proj": _lin(d, d), "o_proj": _lin(d, d),
           "attn_norm": _ln(d), "fc1": _lin(d, bc.ffn_dim), "fc2": _lin(bc.ffn_dim, d),
           "final_norm": _ln(d), "grep_linear": _lin(d // bc.num_heads, 8),
           "grep_a": ("o", (bc.num_heads,), 0.0)}
    p = {"patch_embed": {"w": _normal(bc.patch_size ** 2, e)},
         "patch_norm": _ln(e), "post_extract_proj": _lin(e, d),
         "pos_conv": {"w": _normal(d, d // 16, 128, std=math.sqrt(4.0 / (128 * d))),
                      "b": ("z", (d,), 0.0)},
         "encoder_norm": _ln(d),
         "rel_pos_bias": _normal(bc.num_buckets, bc.num_heads),
         "layers": _stack(bc.num_layers, lay)}
    if bc.conv_bias:
        p["patch_embed"]["b"] = ("z", (e,), 0.0)
    return p


def spec(cfg) -> dict:
    """The parameter tree of a TDC-Video model (cfg: the configuration's
    `model` section as a namespace), every leaf a (kind, shape, std)."""
    H = cfg.lm.hidden_size
    p = {"siglip": _vit(cfg.siglip), "dino": _vit(cfg.dino),
         "sva": _sva(cfg.sva, (cfg.siglip.hidden_size, cfg.dino.hidden_size), H),
         "compressor": _compressor(cfg), "lm": _lm(cfg.lm), "image_newline": _normal(H)}
    if cfg.audio_input:
        p["beats"] = _beats(cfg.beats)
        p["audio_proj"] = _lin(cfg.beats.encoder_embed_dim, H)
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
