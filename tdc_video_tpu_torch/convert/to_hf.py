"""The port's parameter trees -> the reference's torch state-dict layout
(port of tdc_video_tpu/convert/to_hf.py).

Inverse of convert/from_hf.py.  Leaves may be tensors (on any device) or
numpy arrays; the exported state dict holds f32 numpy arrays.  Safetensors
files are written by the writer below (no `safetensors` package).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .from_hf import BF16, SAFETENSORS_DTYPES

Array = np.ndarray
_DTYPE_NAMES = {np.dtype(v): k for k, v in SAFETENSORS_DTYPES.items()}
_DTYPE_NAMES[BF16] = "BF16"


def _np(x) -> Array:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _np_t(x) -> Array:
    """_np of x with its last two axes swapped, contiguous: a tensor is
    transposed where it lies (on the device) before the copy to the host."""
    if isinstance(x, torch.Tensor):
        return _np(x.detach().to(torch.float32).transpose(-1, -2).contiguous())
    return np.ascontiguousarray(_np(x).swapaxes(-1, -2))


def save_safetensors(sd: Dict[str, Array], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `sd` as a safetensors file.  Each tensor's bytes are those of a
    contiguous copy, never a view's base buffer (a transposed view would
    otherwise reload permuted); native little-endian dtypes only.  Tensors are laid out by falling
    item size, so each starts aligned to its own size."""
    arrays = {}
    for k, v in sd.items():
        a = np.asarray(v, order="C")  # a contiguous copy of a view (0-d stays 0-d)
        if a.dtype not in _DTYPE_NAMES:
            raise ValueError(f"tensor {k}: dtype {a.dtype} has no safetensors name")
        arrays[k] = a
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.itemsize, k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for k in order:
        a = arrays[k]
        header[k] = {"dtype": _DTYPE_NAMES[a.dtype], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as fh:
        fh.write(len(blob).to_bytes(8, "little"))
        fh.write(blob)
        for k in order:  # each array's own buffer, no copy
            fh.write(memoryview(arrays[k].reshape(-1).view(np.uint8)))


def _lin(sd: Dict[str, Array], name: str, p) -> None:
    sd[name + ".weight"] = _np_t(p["w"])
    if "b" in p:
        sd[name + ".bias"] = _np(p["b"])


def _ln(sd: Dict[str, Array], name: str, p) -> None:
    sd[name + ".weight"] = _np(p["scale"])
    sd[name + ".bias"] = _np(p["bias"])


def _unstack(tree, i):
    """Layer i of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unstack(v, i) for v in tree)
    return tree[i]


def export_lm(params, cfg, prefix: str = "model.") -> Dict[str, Array]:
    sd: Dict[str, Array] = {}
    sd[prefix + "embed_tokens.weight"] = _np(params["embed"]["embedding"])
    for i in range(params["layers"]["input_norm"]["scale"].shape[0]):
        lp = f"{prefix}layers.{i}."
        L = _unstack(params["layers"], i)
        sd[lp + "input_layernorm.weight"] = _np(L["input_norm"]["scale"])
        _lin(sd, lp + "self_attn.q_proj", L["q_proj"])
        _lin(sd, lp + "self_attn.k_proj", L["k_proj"])
        _lin(sd, lp + "self_attn.v_proj", L["v_proj"])
        _lin(sd, lp + "self_attn.o_proj", L["o_proj"])
        sd[lp + "post_attention_layernorm.weight"] = _np(L["post_attn_norm"]["scale"])
        _lin(sd, lp + "mlp.gate_proj", L["mlp"]["gate"])
        _lin(sd, lp + "mlp.up_proj", L["mlp"]["up"])
        _lin(sd, lp + "mlp.down_proj", L["mlp"]["down"])
    sd[prefix + "norm.weight"] = _np(params["final_norm"]["scale"])
    if "lm_head" in params:
        sd["lm_head.weight"] = _np_t(params["lm_head"]["w"])
    return sd


def export_vit(params, cfg, prefix: str, style: str) -> Dict[str, Array]:
    sd: Dict[str, Array] = {}
    p = cfg.patch_size
    w = _np(params["patch_embed"]["w"])  # [P*P*3, C]
    conv = w.reshape(p, p, 3, -1).transpose(3, 2, 0, 1)
    n_layers = params["layers"]["q_proj"]["w"].shape[0]
    if style == "siglip":
        sd[prefix + "embeddings.patch_embedding.weight"] = conv
        sd[prefix + "embeddings.patch_embedding.bias"] = _np(params["patch_embed"]["b"])
        sd[prefix + "embeddings.position_embedding.weight"] = _np(params["pos_embed"])
        for i in range(n_layers):
            lp = f"{prefix}encoder.layers.{i}."
            L = _unstack(params["layers"], i)
            _ln(sd, lp + "layer_norm1", L["norm1"])
            _lin(sd, lp + "self_attn.q_proj", L["q_proj"])
            _lin(sd, lp + "self_attn.k_proj", L["k_proj"])
            _lin(sd, lp + "self_attn.v_proj", L["v_proj"])
            _lin(sd, lp + "self_attn.out_proj", L["o_proj"])
            _ln(sd, lp + "layer_norm2", L["norm2"])
            _lin(sd, lp + "mlp.fc1", L["mlp"]["fc1"])
            _lin(sd, lp + "mlp.fc2", L["mlp"]["fc2"])
        _ln(sd, prefix + "post_layernorm", params["final_norm"])
    else:
        sd[prefix + "embeddings.patch_embeddings.projection.weight"] = conv
        sd[prefix + "embeddings.patch_embeddings.projection.bias"] = _np(params["patch_embed"]["b"])
        sd[prefix + "embeddings.cls_token"] = _np(params["cls_token"])[None, None]
        sd[prefix + "embeddings.position_embeddings"] = _np(params["pos_embed"])[None]
        for i in range(n_layers):
            lp = f"{prefix}encoder.layer.{i}."
            L = _unstack(params["layers"], i)
            _ln(sd, lp + "norm1", L["norm1"])
            _lin(sd, lp + "attention.attention.query", L["q_proj"])
            _lin(sd, lp + "attention.attention.key", L["k_proj"])
            _lin(sd, lp + "attention.attention.value", L["v_proj"])
            _lin(sd, lp + "attention.output.dense", L["o_proj"])
            _ln(sd, lp + "norm2", L["norm2"])
            sd[lp + "layer_scale1.lambda1"] = _np(L["ls1"])
            sd[lp + "layer_scale2.lambda1"] = _np(L["ls2"])
            _lin(sd, lp + "mlp.weights_in", L["mlp"]["gate_up"])
            _lin(sd, lp + "mlp.weights_out", L["mlp"]["down"])
        _ln(sd, prefix + "layernorm", params["final_norm"])
    return sd


def export_qformer(params, cfg, prefix: str) -> Dict[str, Array]:
    sd: Dict[str, Array] = {}
    emb = params["embeddings"]
    sd[prefix + "embeddings.word_embeddings.weight"] = _np(emb["word"])
    sd[prefix + "embeddings.position_embeddings.weight"] = _np(emb["position"])
    _ln(sd, prefix + "embeddings.LayerNorm", emb["norm"])
    for i, L in enumerate(params["layers"]):
        lp = f"{prefix}encoder.layer.{i}."

        def attn(kind, A):
            _lin(sd, lp + kind + ".self.query", A["q_proj"])
            _lin(sd, lp + kind + ".self.key", A["k_proj"])
            _lin(sd, lp + kind + ".self.value", A["v_proj"])
            _lin(sd, lp + kind + ".output.dense", A["o_proj"])
            _ln(sd, lp + kind + ".output.LayerNorm", A["norm"])

        attn("attention", L["self_attn"])
        if L["cross_attn"] is not None:
            attn("crossattention", L["cross_attn"])
        for q, F in (("", L["ffn"]), ("_query", L["ffn_query"])):
            _lin(sd, lp + f"intermediate{q}.dense", F["fc1"])
            _lin(sd, lp + f"output{q}.dense", F["fc2"])
            _ln(sd, lp + f"output{q}.LayerNorm", F["norm"])
    return sd


def export_sva(params, prefix: str = "model.") -> Dict[str, Array]:
    sd: Dict[str, Array] = {}
    for t, ap in enumerate(params["aux_projectors"]):
        name = f"{prefix}mm_projector_aux_{t}."
        _lin(sd, name + "0", ap["fc1"])
        _lin(sd, name + "2", ap["fc2"])
        _ln(sd, name + "3", ap["norm"])
    for g, sampler in enumerate(params["samplers"]):
        for li, L in enumerate(sampler["layers"]):
            lp = f"{prefix}vision_sampler_{g}.layers.{li}."
            _lin(sd, lp + "proj_context", L["proj_context"])
            _lin(sd, lp + "proj_in", L["proj_in"])
            _ln(sd, lp + "cross_attn.q_proj.0", L["q_proj"]["norm"])
            _lin(sd, lp + "cross_attn.q_proj.1", L["q_proj"]["lin"])
            for t, kv in enumerate(L["kv"]):
                _ln(sd, lp + f"cross_attn.k_proj_{t}.0", kv["k_proj"]["norm"])
                _lin(sd, lp + f"cross_attn.k_proj_{t}.1", kv["k_proj"]["lin"])
                _ln(sd, lp + f"cross_attn.v_proj_{t}.0", kv["v_proj"]["norm"])
                _lin(sd, lp + f"cross_attn.v_proj_{t}.1", kv["v_proj"]["lin"])
            for t, pe in enumerate(L["pos_embed"]):
                if pe is not None:
                    sd[lp + f"pos_embed_{t}"] = _np(pe)
            _lin(sd, lp + "cross_attn.o_proj", L["o_proj"])
            _ln(sd, lp + "norm", L["norm"])
            _lin(sd, lp + "proj_out.linear_1", L["proj_out"]["fc1"])
            _lin(sd, lp + "proj_out.linear_2", L["proj_out"]["fc2"])
    sd[prefix + "vision_query"] = _np(params["vision_query"])
    _lin(sd, prefix + "mm_projector.0", params["mm_projector"]["fc1"])
    _lin(sd, prefix + "mm_projector.2", params["mm_projector"]["fc2"])
    return sd


def export_beats(params, prefix: str) -> Dict[str, Array]:
    """Inverse of convert_beats: pos_conv written as weight_g = ||w|| (over
    axes 0 and 1) and weight_v = w, so that the fold gives w back."""
    sd: Dict[str, Array] = {}
    pe = _np(params["patch_embed"]["w"])  # [256, C]
    p_ = int(np.sqrt(pe.shape[0]))
    sd[prefix + "patch_embedding.weight"] = pe.reshape(p_, p_, 1, -1).transpose(3, 2, 0, 1)
    if "b" in params["patch_embed"]:
        sd[prefix + "patch_embedding.bias"] = _np(params["patch_embed"]["b"])
    _ln(sd, prefix + "layer_norm", params["patch_norm"])
    _lin(sd, prefix + "post_extract_proj", params["post_extract_proj"])
    w = _np(params["pos_conv"]["w"])  # [O, I/G, K]
    sd[prefix + "encoder.pos_conv.0.weight_g"] = np.sqrt((w * w).sum(axis=(0, 1), keepdims=True))
    sd[prefix + "encoder.pos_conv.0.weight_v"] = w
    sd[prefix + "encoder.pos_conv.0.bias"] = _np(params["pos_conv"]["b"])
    _ln(sd, prefix + "encoder.layer_norm", params["encoder_norm"])
    for i in range(params["layers"]["q_proj"]["w"].shape[0]):
        lp = f"{prefix}encoder.layers.{i}."
        L = _unstack(params["layers"], i)
        _lin(sd, lp + "self_attn.q_proj", L["q_proj"])
        _lin(sd, lp + "self_attn.k_proj", L["k_proj"])
        _lin(sd, lp + "self_attn.v_proj", L["v_proj"])
        _lin(sd, lp + "self_attn.out_proj", L["o_proj"])
        _ln(sd, lp + "self_attn_layer_norm", L["attn_norm"])
        _lin(sd, lp + "fc1", L["fc1"])
        _lin(sd, lp + "fc2", L["fc2"])
        _ln(sd, lp + "final_layer_norm", L["final_norm"])
        _lin(sd, lp + "self_attn.grep_linear", L["grep_linear"])
        sd[lp + "self_attn.grep_a"] = _np(L["grep_a"]).reshape(1, -1, 1, 1)
    sd[prefix + "encoder.layers.0.self_attn.relative_attention_bias.weight"] = _np(
        params["rel_pos_bias"])
    return sd


def export_compressor(params, cfg, prefix: str = "model.") -> Dict[str, Array]:
    sd = export_qformer(params["qformer"], cfg, prefix + "Qformer.bert.")
    _lin(sd, prefix + "query_proj", params["query_proj"])
    _lin(sd, prefix + "vision_proj", params["vision_proj"])
    sd[prefix + "query_tokens"] = _np(params["query_tokens"])[None]
    sd[prefix + "frame_seg"] = _np(params["frame_seg"])
    return sd


def export_tdc(params, cfg, prefix: str = "model.") -> Dict[str, Array]:
    """Full tree -> reference-format flat state dict."""
    sd = export_lm(params["lm"], cfg.lm, prefix)
    sd.update(export_vit(params["siglip"], cfg.siglip,
                         prefix + "vision_tower_aux_list.0.vision_tower.vision_model.", "siglip"))
    sd.update(export_vit(params["dino"], cfg.dino,
                         prefix + "vision_tower_aux_list.1.vision_tower.", "dino"))
    sd.update(export_sva(params["sva"], prefix))
    sd.update(export_compressor(params["compressor"], cfg.qformer, prefix))
    sd[prefix + "image_newline"] = _np(params["image_newline"])
    if "audio_proj" in params:
        _lin(sd, prefix + "audio_proj", params["audio_proj"])
    if "beats" in params:
        sd.update(export_beats(params["beats"], prefix + "audio_encoder.beats."))
    return sd


def tdc_overrides_dict(cfg) -> dict:
    """Nested per-module dims for an exact config round trip: written into
    config.json under "tdc_tpu_overrides" and read back by
    builder.read_config (the JAX package's own extension, absent from
    reference checkpoints, needed to reload non-default dims)."""

    def vit(v):
        return {
            "image_size": v.image_size,
            "hidden_size": v.hidden_size,
            "num_layers": v.num_layers,
            "num_heads": v.num_heads,
            "intermediate_size": v.intermediate_size,
            "interp_tokens": v.interp_tokens,
            "use_cls_token": v.use_cls_token,
            "use_swiglu": v.use_swiglu,
            "layerscale": v.layerscale,
        }

    return {
        "lm": {
            "head_dim": cfg.lm.head_dim,
            "rope_theta": cfg.lm.rope_theta,
            "rope_scaling": list(cfg.lm.rope_scaling) if cfg.lm.rope_scaling else None,
            "attention_bias": cfg.lm.attention_bias,
            "pad_token_id": cfg.lm.pad_token_id,
            "eos_token_ids": list(cfg.lm.eos_token_ids),
            "max_position_embeddings": cfg.lm.max_position_embeddings,
        },
        "siglip": vit(cfg.siglip),
        "dino": vit(cfg.dino),
        "qformer": {
            "vocab_size": cfg.qformer.vocab_size,
            "hidden_size": cfg.qformer.hidden_size,
            "num_layers": cfg.qformer.num_layers,
            "num_heads": cfg.qformer.num_heads,
            "intermediate_size": cfg.qformer.intermediate_size,
            "max_position_embeddings": cfg.qformer.max_position_embeddings,
            "query_length": cfg.qformer.query_length,
        },
        "sva": {"tower_token_len_list": list(cfg.sva.tower_token_len_list)},
        # beats dims always recorded so the config round-trips even audio-off
        "beats": {
            "embed_dim": cfg.beats.embed_dim,
            "encoder_embed_dim": cfg.beats.encoder_embed_dim,
            "num_layers": cfg.beats.num_layers,
            "num_heads": cfg.beats.num_heads,
            "ffn_dim": cfg.beats.ffn_dim,
            "num_buckets": cfg.beats.num_buckets,
            "max_distance": cfg.beats.max_distance,
        },
    }


def save_checkpoint_dir(params, cfg, out_dir: str, hf_config: dict = None) -> None:
    """Write model.safetensors + config.json in the reference layout."""
    os.makedirs(out_dir, exist_ok=True)
    save_safetensors(export_tdc(params, cfg), os.path.join(out_dir, "model.safetensors"))
    hf = hf_config or {}
    is_qwen = cfg.lm.name == "qwen2"
    hf.setdefault("model_type", "cambrian_qwen" if is_qwen else "cambrian_llama")
    hf.setdefault("architectures",
                  ["CambrianQwenForCausalLM" if is_qwen else "CambrianLlamaForCausalLM"])
    hf.setdefault("tie_word_embeddings", cfg.lm.tie_word_embeddings)
    hf.setdefault("tdc_tpu_overrides", tdc_overrides_dict(cfg))
    hf.setdefault("hidden_size", cfg.lm.hidden_size)
    hf.setdefault("num_hidden_layers", cfg.lm.num_layers)
    hf.setdefault("num_attention_heads", cfg.lm.num_heads)
    hf.setdefault("num_key_value_heads", cfg.lm.num_kv_heads)
    hf.setdefault("intermediate_size", cfg.lm.intermediate_size)
    hf.setdefault("vocab_size", cfg.lm.vocab_size)
    hf.setdefault("rope_theta", cfg.lm.rope_theta)
    hf.setdefault("rms_norm_eps", cfg.lm.rms_norm_eps)
    hf.setdefault("max_position_embeddings", cfg.lm.max_position_embeddings)
    # compression + SVA attributes, read back by read_config
    hf.setdefault("context_token_num", cfg.compression.context_token_num)
    hf.setdefault("query_type", cfg.compression.query_type)
    hf.setdefault("add_static", cfg.compression.add_static)
    hf.setdefault("text_input", cfg.compression.text_input)
    hf.setdefault("max_num_segments", cfg.compression.max_num_segments)
    hf.setdefault("frame_pos", cfg.compression.frame_pos)
    hf.setdefault("is_image_newline", cfg.compression.is_image_newline)
    hf.setdefault("image_token_len", cfg.sva.image_token_len)
    hf.setdefault("query_num_list", list(cfg.sva.query_num_list))
    hf.setdefault("vision_hidden_size", cfg.sva.vision_hidden_size)
    hf.setdefault("num_query_group", cfg.sva.num_query_group)
    hf.setdefault("connector_depth", cfg.sva.connector_depth)
    hf.setdefault("audio_input", cfg.audio_input)
    hf.setdefault("tokenizer_model_max_length", cfg.tokenizer_model_max_length)
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(hf, fh, indent=2)


def export_mm_adapter(params) -> Dict[str, Array]:
    """Adapter-only artifact (the reference's mm_projector.bin flavour):
    projector, samplers, vision_query and image_newline."""
    sd = export_sva(params["sva"], prefix="model.")
    sd["model.image_newline"] = _np(params["image_newline"])
    return sd


def save_mm_adapter(params, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_safetensors(export_mm_adapter(params), path)
