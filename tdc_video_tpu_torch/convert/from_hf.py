"""Reference-format checkpoints -> the port's parameter trees (port of
tdc_video_tpu/convert/from_hf.py).

Each converter maps a flat state dict (name -> numpy array) into the JAX
layout: weights [d_in, d_out], layers stacked on axis 0.  Safetensors files
are read by the reader below (no `safetensors` package), memory-mapped, so
that a tensor's bytes are read only when a converter touches them.

Every leaf passes through `put` as soon as it is made: by default a
contiguous numpy copy (the JAX converters' output, bit for bit); the loader
(builder.py) passes a function that moves the leaf to the device, so that a
model is converted leaf by leaf and the host never holds a converted copy
of all its weights.  Per-layer leaves stay views of the state dict until
`_stack` stacks them, one leaf at a time.  BF16 tensors, which numpy cannot
hold, are read as their raw bits under a tagged dtype (`BF16`) and widened
to f32 (`widen_bf16`) only where a leaf is made for numpy; the loader hands
them to torch as bfloat16.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np

from ..config import BeatsConfig, LMConfig, QFormerConfig, ViTConfig

Array = np.ndarray
StateDict = Mapping[str, Array]
Put = Callable[[Array], Any]

# bfloat16 bits as numpy holds them: one 16-bit field, so that views,
# transposes and stacks keep the tag
BF16 = np.dtype([("bf16", "<u2")])
# safetensors dtype names -> numpy
SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}


def _is_safetensors(path: str) -> bool:
    """Content sniff, not extension: a safetensors file opens with a u64
    little-endian header length followed by a JSON header (an exporter's
    mm_projector.bin may be safetensors)."""
    if path.endswith(".safetensors"):
        return True
    try:
        with open(path, "rb") as fh:
            head = fh.read(9)
        n = int.from_bytes(head[:8], "little")
        return len(head) == 9 and 0 < n < 100_000_000 and head[8:9] in (b"{", b" ")
    except OSError:
        return False


def widen_bf16(x: Array) -> Array:
    """A BF16-tagged array -> its f32 values (exact); other arrays as they are."""
    if x.dtype != BF16:
        return x
    return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path: str) -> Dict[str, Array]:
    """A safetensors file -> {name: array}: read-only views of one memory map
    of the file, BF16 tensors under the `BF16` tag.  The header's
    `__metadata__` is skipped."""
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    base = 8 + n
    out: Dict[str, Array] = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        raw = mm[base + start: base + end]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            out[name] = raw.view(BF16).reshape(shape)
        elif info["dtype"] in SAFETENSORS_DTYPES:
            out[name] = raw.view(SAFETENSORS_DTYPES[info["dtype"]]).reshape(shape)
        else:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
    return out


def load_torch_state_dict(path: str) -> Dict[str, Array]:
    """Read a .bin/.pt/.safetensors checkpoint into numpy arrays."""
    if _is_safetensors(path):
        return read_safetensors(path)
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]  # BEATs checkpoints nest under "model"
    return {k: v.to(torch.float32).numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def _contiguous(x: Array) -> Array:
    return np.ascontiguousarray(widen_bf16(x))


def _view(x: Array) -> Array:
    """Per-layer leaves: left as views until `_stack` copies them."""
    return x


def _lin(sd: StateDict, prefix: str, bias: bool = True, put: Put = _contiguous) -> Dict[str, Any]:
    p = {"w": put(sd[prefix + ".weight"].T)}
    if bias and prefix + ".bias" in sd:
        p["b"] = put(sd[prefix + ".bias"])
    return p


def _ln(sd: StateDict, prefix: str, put: Put = _contiguous) -> Dict[str, Any]:
    return {"scale": put(sd[prefix + ".weight"]), "bias": put(sd[prefix + ".bias"])}


def _stack(trees, put: Put = _contiguous):
    """Stack a list of identical trees along a new leading axis, leaf by
    leaf, each stacked leaf through `put` before the next is made."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], put) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees], put) for i in range(len(first)))
    return put(np.stack(trees, 0))


# ---------------------------------------------------------------------------
# LLM (Qwen2 / Llama): HF "model.layers.N.*" layout
# ---------------------------------------------------------------------------


def convert_lm(sd: StateDict, cfg: LMConfig, prefix: str = "model.", put: Put = _contiguous):
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}layers.{i}."
        layers.append(
            {
                "input_norm": {"scale": sd[lp + "input_layernorm.weight"]},
                "q_proj": _lin(sd, lp + "self_attn.q_proj", put=_view),
                "k_proj": _lin(sd, lp + "self_attn.k_proj", put=_view),
                "v_proj": _lin(sd, lp + "self_attn.v_proj", put=_view),
                "o_proj": _lin(sd, lp + "self_attn.o_proj", bias=False, put=_view),
                "post_attn_norm": {"scale": sd[lp + "post_attention_layernorm.weight"]},
                "mlp": {
                    "gate": _lin(sd, lp + "mlp.gate_proj", bias=False, put=_view),
                    "up": _lin(sd, lp + "mlp.up_proj", bias=False, put=_view),
                    "down": _lin(sd, lp + "mlp.down_proj", bias=False, put=_view),
                },
            }
        )
    params = {
        "embed": {"embedding": put(sd[prefix + "embed_tokens.weight"])},
        "layers": _stack(layers, put),
        "final_norm": {"scale": put(sd[prefix + "norm.weight"])},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": put(sd["lm_head.weight"].T)}
    return params


# ---------------------------------------------------------------------------
# SigLIP and DINOv2 towers
# ---------------------------------------------------------------------------


def _patch_embed(conv_w: Array) -> Array:
    """HF conv patch embed [H, 3, P, P] -> dense [P*P*3, H] on flattened
    patches."""
    h, c, p, _ = conv_w.shape
    return conv_w.transpose(2, 3, 1, 0).reshape(p * p * c, h)


def convert_siglip(sd: StateDict, cfg: ViTConfig, prefix: str = "vision_model.",
                   put: Put = _contiguous):
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}encoder.layers.{i}."
        layers.append(
            {
                "norm1": _ln(sd, lp + "layer_norm1", put=_view),
                "q_proj": _lin(sd, lp + "self_attn.q_proj", put=_view),
                "k_proj": _lin(sd, lp + "self_attn.k_proj", put=_view),
                "v_proj": _lin(sd, lp + "self_attn.v_proj", put=_view),
                "o_proj": _lin(sd, lp + "self_attn.out_proj", put=_view),
                "norm2": _ln(sd, lp + "layer_norm2", put=_view),
                "mlp": {
                    "fc1": _lin(sd, lp + "mlp.fc1", put=_view),
                    "fc2": _lin(sd, lp + "mlp.fc2", put=_view),
                },
            }
        )
    return {
        "patch_embed": {"w": put(_patch_embed(sd[prefix + "embeddings.patch_embedding.weight"])),
                        "b": put(sd[prefix + "embeddings.patch_embedding.bias"])},
        "pos_embed": put(sd[prefix + "embeddings.position_embedding.weight"]),
        "layers": _stack(layers, put),
        "final_norm": _ln(sd, prefix + "post_layernorm", put),
    }


def convert_dinov2(sd: StateDict, cfg: ViTConfig, prefix: str = "", put: Put = _contiguous):
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}encoder.layer.{i}."
        layer = {
            "norm1": _ln(sd, lp + "norm1", put=_view),
            "q_proj": _lin(sd, lp + "attention.attention.query", put=_view),
            "k_proj": _lin(sd, lp + "attention.attention.key", put=_view),
            "v_proj": _lin(sd, lp + "attention.attention.value", put=_view),
            "o_proj": _lin(sd, lp + "attention.output.dense", put=_view),
            "norm2": _ln(sd, lp + "norm2", put=_view),
            "ls1": sd[lp + "layer_scale1.lambda1"],
            "ls2": sd[lp + "layer_scale2.lambda1"],
        }
        if cfg.use_swiglu:
            layer["mlp"] = {"gate_up": _lin(sd, lp + "mlp.weights_in", put=_view),
                            "down": _lin(sd, lp + "mlp.weights_out", put=_view)}
        else:
            layer["mlp"] = {"fc1": _lin(sd, lp + "mlp.fc1", put=_view),
                            "fc2": _lin(sd, lp + "mlp.fc2", put=_view)}
        layers.append(layer)
    emb = prefix + "embeddings."
    return {
        "patch_embed": {"w": put(_patch_embed(sd[emb + "patch_embeddings.projection.weight"])),
                        "b": put(sd[emb + "patch_embeddings.projection.bias"])},
        # HF stores [1, 1, H]; the tree holds a flat [H] vector
        "cls_token": put(np.asarray(sd[emb + "cls_token"]).reshape(-1)),
        "pos_embed": put(sd[emb + "position_embeddings"][0]),
        "layers": _stack(layers, put),
        "final_norm": _ln(sd, prefix + "layernorm", put),
    }


# ---------------------------------------------------------------------------
# BERT Q-Former ("bert.encoder.layer.N" layout)
# ---------------------------------------------------------------------------


def convert_qformer(sd: StateDict, cfg: QFormerConfig, prefix: str = "bert.",
                    put: Put = _contiguous):
    def attn(lp: str, kind: str) -> Dict[str, Any]:
        ap = f"{lp}{kind}."
        return {
            "q_proj": _lin(sd, ap + "self.query", put=put),
            "k_proj": _lin(sd, ap + "self.key", put=put),
            "v_proj": _lin(sd, ap + "self.value", put=put),
            "o_proj": _lin(sd, ap + "output.dense", put=put),
            "norm": _ln(sd, ap + "output.LayerNorm", put),
        }

    def ffn(lp: str, q: str) -> Dict[str, Any]:
        return {"fc1": _lin(sd, f"{lp}intermediate{q}.dense", put=put),
                "fc2": _lin(sd, f"{lp}output{q}.dense", put=put),
                "norm": _ln(sd, f"{lp}output{q}.LayerNorm", put)}

    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}encoder.layer.{i}."
        layers.append({
            "self_attn": attn(lp, "attention"),
            # layers without cross-attention hold None (the tree stays a list)
            "cross_attn": attn(lp, "crossattention") if i % cfg.cross_attention_freq == 0 else None,
            "ffn": ffn(lp, ""),
            "ffn_query": ffn(lp, "_query"),
        })
    return {
        "embeddings": {
            "word": put(sd[prefix + "embeddings.word_embeddings.weight"]),
            "position": put(sd[prefix + "embeddings.position_embeddings.weight"]),
            "norm": _ln(sd, prefix + "embeddings.LayerNorm", put),
        },
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# SVA connector + compressor extras of a trained TDC checkpoint
# ---------------------------------------------------------------------------


def _ln_lin(sd: StateDict, prefix: str, put: Put = _contiguous) -> Dict[str, Any]:
    """nn.Sequential(LayerNorm, Linear), as in the SVA's q/k/v projections."""
    return {"norm": _ln(sd, prefix + ".0", put), "lin": _lin(sd, prefix + ".1", bias=False, put=put)}


def convert_sva(sd: StateDict, num_towers: int, num_groups: int, depth: int,
                prefix: str = "model.", put: Put = _contiguous) -> Dict[str, Any]:
    params: Dict[str, Any] = {"aux_projectors": [], "samplers": []}
    for t in range(num_towers):
        ap = f"{prefix}mm_projector_aux_{t}."
        params["aux_projectors"].append(
            {"fc1": _lin(sd, ap + "0", put=put), "fc2": _lin(sd, ap + "2", put=put),
             "norm": _ln(sd, ap + "3", put)})
    for gi in range(num_groups):
        layers = []
        for li in range(depth):
            lp = f"{prefix}vision_sampler_{gi}.layers.{li}."
            layers.append({
                "proj_context": _lin(sd, lp + "proj_context", bias=False, put=put),
                "proj_in": _lin(sd, lp + "proj_in", bias=False, put=put),
                "q_proj": _ln_lin(sd, lp + "cross_attn.q_proj", put),
                "o_proj": _lin(sd, lp + "cross_attn.o_proj", bias=False, put=put),
                "norm": _ln(sd, lp + "norm", put),
                "proj_out": {"fc1": _lin(sd, lp + "proj_out.linear_1", bias=False, put=put),
                             "fc2": _lin(sd, lp + "proj_out.linear_2", bias=False, put=put)},
                "kv": [{"k_proj": _ln_lin(sd, lp + f"cross_attn.k_proj_{t}", put),
                        "v_proj": _ln_lin(sd, lp + f"cross_attn.v_proj_{t}", put)}
                       for t in range(num_towers)],
                "pos_embed": [None if lp + f"pos_embed_{t}" not in sd else put(sd[lp + f"pos_embed_{t}"])
                              for t in range(num_towers)],
            })
        params["samplers"].append({"layers": layers})
    params["vision_query"] = put(sd[prefix + "vision_query"])
    params["mm_projector"] = {"fc1": _lin(sd, prefix + "mm_projector.0", put=put),
                              "fc2": _lin(sd, prefix + "mm_projector.2", put=put)}
    return params


def convert_beats(sd: StateDict, cfg: BeatsConfig, prefix: str = "", put: Put = _contiguous):
    """A BEATs checkpoint (BEATs_iter3_plus_AS2M*.pt, nested under "model")
    -> models/beats.py's tree.  The weight-normed pos_conv (weight_norm over
    dim 2: g [1, 1, K], v [O, I/G, K]) is folded into a plain conv weight,
    g * v / ||v|| with the norm over axes 0 and 1."""
    patch = {"w": put(_patch_embed(sd[prefix + "patch_embedding.weight"]))}
    if prefix + "patch_embedding.bias" in sd:
        patch["b"] = put(sd[prefix + "patch_embedding.bias"])
    g = widen_bf16(sd[prefix + "encoder.pos_conv.0.weight_g"])
    v = widen_bf16(sd[prefix + "encoder.pos_conv.0.weight_v"])
    norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    pos_w = (g / np.maximum(norm, 1e-12)) * v  # [O, I/G, K]

    layers = []
    for i in range(cfg.num_layers):
        lp = f"{prefix}encoder.layers.{i}."
        layers.append(
            {
                "q_proj": _lin(sd, lp + "self_attn.q_proj", put=_view),
                "k_proj": _lin(sd, lp + "self_attn.k_proj", put=_view),
                "v_proj": _lin(sd, lp + "self_attn.v_proj", put=_view),
                "o_proj": _lin(sd, lp + "self_attn.out_proj", put=_view),
                "attn_norm": _ln(sd, lp + "self_attn_layer_norm", put=_view),
                "fc1": _lin(sd, lp + "fc1", put=_view),
                "fc2": _lin(sd, lp + "fc2", put=_view),
                "final_norm": _ln(sd, lp + "final_layer_norm", put=_view),
                "grep_linear": _lin(sd, lp + "self_attn.grep_linear", put=_view),
                "grep_a": sd[lp + "self_attn.grep_a"].reshape(-1),
            }
        )
    return {
        "patch_embed": patch,
        "patch_norm": _ln(sd, prefix + "layer_norm", put),
        "post_extract_proj": _lin(sd, prefix + "post_extract_proj", put=put),
        "pos_conv": {"w": put(pos_w), "b": put(sd[prefix + "encoder.pos_conv.0.bias"])},
        "encoder_norm": _ln(sd, prefix + "encoder.layer_norm", put),
        "rel_pos_bias": put(
            sd[prefix + "encoder.layers.0.self_attn.relative_attention_bias.weight"]),
        "layers": _stack(layers, put),
    }


def convert_compressor(sd: StateDict, cfg: QFormerConfig, prefix: str = "model.",
                       put: Put = _contiguous) -> Dict[str, Any]:
    """Q-Former + projections + frame separator."""
    return {
        "qformer": convert_qformer(sd, cfg, prefix=prefix + "Qformer.bert.", put=put),
        "query_proj": _lin(sd, prefix + "query_proj", put=put),
        "vision_proj": _lin(sd, prefix + "vision_proj", put=put),
        "query_tokens": put(sd[prefix + "query_tokens"][0]),
        "frame_seg": put(sd[prefix + "frame_seg"]),
    }


def convert_tdc(sd: StateDict, cfg, prefix: str = "model.", put: Optional[Put] = None):
    """Full TDC-Video checkpoint (CambrianQwen/LlamaForCausalLM state dict)
    -> model.init_tdc's tree.  `cfg` is a config.TDCConfig.  BEATs and
    audio_proj are converted where the state dict holds them."""
    put = put or _contiguous
    params = {
        "lm": convert_lm(sd, cfg.lm, prefix=prefix, put=put),
        "siglip": convert_siglip(sd, cfg.siglip, put=put,
                                 prefix=prefix + "vision_tower_aux_list.0.vision_tower.vision_model."),
        "dino": convert_dinov2(sd, cfg.dino, prefix=prefix + "vision_tower_aux_list.1.vision_tower.",
                               put=put),
        "sva": convert_sva(sd, num_towers=2, num_groups=cfg.sva.num_query_group,
                           depth=cfg.sva.connector_depth, prefix=prefix, put=put),
        "compressor": convert_compressor(sd, cfg.qformer, prefix=prefix, put=put),
        "image_newline": put(sd[prefix + "image_newline"]),
    }
    if prefix + "audio_proj.weight" in sd:
        params["audio_proj"] = _lin(sd, prefix + "audio_proj", put=put)
    beats_prefix = prefix + "audio_encoder.beats."
    if beats_prefix + "patch_embedding.weight" in sd:
        params["beats"] = convert_beats(sd, cfg.beats, prefix=beats_prefix, put=put)
    return params
