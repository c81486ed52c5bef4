"""Model loading: reference-format checkpoints -> (tokenizer, model bundle)
(port of tdc_video_tpu/builder.py, float path).

Reads a TDC-Video checkpoint directory (config.json + safetensors or .bin
shards), maps the state dict into the port's parameter tree
(convert/from_hf.py) leaf by leaf onto the device, and handles the LoRA
flavour (base model + adapter deltas merged in numpy) and projector-only
adapters.  quantize="int8" makes the LM weight-only int8; "int8-all" also
makes both towers int8 (models/quant.py).
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import config as C
from .convert import from_hf
from .device import resolve_device


def read_config(model_path: str) -> C.TDCConfig:
    """Build a TDCConfig from a reference-style HF config.json."""
    with open(os.path.join(model_path, "config.json")) as fh:
        hf = json.load(fh)
    model_type = hf.get("model_type", "")
    arch = " ".join(hf.get("architectures", []))
    is_llama = "llama" in (model_type + arch).lower()
    cfg = C.tdc_llama32_3b() if is_llama else C.tdc_qwen2_7b()

    lm = replace(
        cfg.lm,
        vocab_size=hf.get("vocab_size", cfg.lm.vocab_size),
        hidden_size=hf.get("hidden_size", cfg.lm.hidden_size),
        num_layers=hf.get("num_hidden_layers", cfg.lm.num_layers),
        num_heads=hf.get("num_attention_heads", cfg.lm.num_heads),
        num_kv_heads=hf.get("num_key_value_heads", cfg.lm.num_kv_heads),
        intermediate_size=hf.get("intermediate_size", cfg.lm.intermediate_size),
        rope_theta=hf.get("rope_theta", cfg.lm.rope_theta),
        rms_norm_eps=hf.get("rms_norm_eps", cfg.lm.rms_norm_eps),
        max_position_embeddings=hf.get("max_position_embeddings", cfg.lm.max_position_embeddings),
        tie_word_embeddings=hf.get("tie_word_embeddings", cfg.lm.tie_word_embeddings),
    )
    comp = replace(
        cfg.compression,
        context_token_num=hf.get("context_token_num", 16),
        query_type=hf.get("query_type", "Avg_pool"),
        add_static=hf.get("add_static", True),
        text_input=hf.get("text_input", True),
        max_num_segments=hf.get("max_num_segments", 24),
        audio_input=hf.get("audio_input", False),
        frame_pos=hf.get("frame_pos", False),
        is_image_newline=hf.get("is_image_newline", True),
    )
    image_token_len = hf.get("image_token_len", 144)
    query_num_list = hf.get("query_num_list", [image_token_len])
    if isinstance(query_num_list, str):
        query_num_list = json.loads(query_num_list)
    sva = replace(
        cfg.sva,
        image_token_len=image_token_len,
        query_num_list=tuple(query_num_list),
        vision_hidden_size=hf.get("vision_hidden_size", 1024),
        num_query_group=hf.get("num_query_group", 1),
        connector_depth=hf.get("connector_depth", 3),
    )
    qf = replace(cfg.qformer, encoder_width=lm.hidden_size)
    cfg = replace(
        cfg,
        lm=lm,
        compression=comp,
        sva=sva,
        qformer=qf,
        audio_input=hf.get("audio_input", False),
        tokenizer_model_max_length=hf.get("tokenizer_model_max_length", 8192),
        conv_version="llama3_2" if is_llama else "qwen",
    )
    # the JAX package's own extension (absent from reference checkpoints):
    # nested dataclass overrides, e.g. tiny tower dims
    for section, vals in (hf.get("tdc_tpu_overrides") or {}).items():
        vals = {k: tuple(v) if isinstance(v, list) else v for k, v in vals.items()}
        cfg = replace(cfg, **{section: replace(getattr(cfg, section), **vals)})
    return cfg


def load_state_dict(model_path: str) -> Dict[str, np.ndarray]:
    """Merge every weight shard in the directory (safetensors preferred)."""
    sd: Dict[str, np.ndarray] = {}
    shards = sorted(glob.glob(os.path.join(model_path, "*.safetensors")))
    if not shards:
        shards = sorted(glob.glob(os.path.join(model_path, "pytorch_model*.bin")))
    if not shards:
        raise FileNotFoundError(f"no weight shards in {model_path}")
    for s in shards:
        sd.update(from_hf.load_torch_state_dict(s))
    return sd


def merge_lora(
    sd: Dict[str, np.ndarray],
    adapter_sd: Dict[str, np.ndarray],
    scaling: Optional[float] = None,
    adapter_config: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Merge peft LoRA deltas into the base state dict: keys
    base_model.model.<module>.lora_A.weight [r, in] and lora_B.weight
    [out, r]; W += B @ A * (lora_alpha / r).  Non-LoRA entries of the
    adapter override the base."""
    if scaling is None:
        if adapter_config is None:
            raise ValueError("need scaling or adapter_config")
        scaling = adapter_config["lora_alpha"] / adapter_config["r"]
    out = dict(sd)
    for k, a in adapter_sd.items():
        if ".lora_A." not in k:
            continue
        b = adapter_sd[k.replace(".lora_A.", ".lora_B.")]
        base_key = (
            k.replace("base_model.model.", "")
            .replace(".lora_A.weight", ".weight")
            .replace(".lora_A.default.weight", ".weight")
        )
        if base_key not in out:
            raise KeyError(f"LoRA target {base_key} missing from base state dict")
        w = from_hf.widen_bf16
        out[base_key] = w(out[base_key]) + (w(b) @ w(a)) * scaling
    for k, v in adapter_sd.items():
        if ".lora_A." in k or ".lora_B." in k:
            continue
        out[k.replace("base_model.model.", "")] = v
    return out


class TDCModel:
    """Loaded model bundle: config + parameter tree."""

    def __init__(self, cfg: C.TDCConfig, params: Any):
        self.cfg = cfg
        self.params = params


def _to_device(device: torch.device, dtype: torch.dtype):
    """The converters' `put`: one leaf to a tensor on `device`, floats
    (bfloat16 from its tagged bits) cast to `dtype`, integer and bool leaves
    keeping their type."""

    def put(a: np.ndarray) -> torch.Tensor:
        bf16 = a.dtype == from_hf.BF16
        if bf16:
            a = a.view(np.int16)
        t = torch.from_numpy(np.require(a, requirements=("C", "A", "W")))
        if bf16:
            t = t.view(torch.bfloat16)
        return t.to(device, dtype) if t.is_floating_point() else t.to(device)

    return put


def load_pretrained_model(
    model_path: str,
    model_base: Optional[str] = None,
    model_name: Optional[str] = None,
    dtype: Optional[torch.dtype] = None,
    load_tokenizer: bool = True,
    quantize: Optional[str] = None,  # "int8": weight-only int8 LM; "int8-all": + int8 towers
    device=None,
    calib_pixels: Optional[Tuple[Any, Any]] = None,  # (siglip_px, dino_px): static tower scales
) -> Tuple[Any, TDCModel, list, int]:
    """Reference-compatible loader: returns (tokenizer, model,
    image_preprocess_list, context_len).

    `dtype` sets the compute dtype (cfg.dtype); the float weights are kept
    in cfg.param_dtype (f32), as in the JAX package.  The state dict is
    memory-mapped and converted leaf by leaf onto `device` (CUDA unless
    "cpu" is asked for).  quantize="int8" quantizes the LM (weight-only);
    "int8-all" also both towers, with static activation scales calibrated
    on `calib_pixels` (normalized [N, H, W, 3] batches, run through the float
    towers once) when given, per-token scales otherwise."""
    if quantize not in (None, "none", "int8", "int8-all"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    device = resolve_device(device)
    model_name = model_name or os.path.basename(model_path)
    cfg = read_config(model_path)
    if dtype is not None:
        cfg = replace(cfg, dtype=dtype)

    if "lora" in model_name.lower() and model_base is not None:
        base_sd = load_state_dict(model_base)
        adapter_sd = {}
        for f in ("adapter_model.safetensors", "adapter_model.bin"):
            p = os.path.join(model_path, f)
            if os.path.exists(p):
                adapter_sd.update(from_hf.load_torch_state_dict(p))
        nlt = os.path.join(model_path, "non_lora_trainables.bin")
        if os.path.exists(nlt):
            extra = from_hf.load_torch_state_dict(nlt)
            adapter_sd.update({k: v for k, v in extra.items() if ".lora_" not in k})
        with open(os.path.join(model_path, "adapter_config.json")) as fh:
            acfg = json.load(fh)
        sd = merge_lora(base_sd, adapter_sd, adapter_config=acfg)
    else:
        sd = load_state_dict(model_path)

    params = from_hf.convert_tdc(sd, cfg, put=_to_device(device, cfg.param_dtype))
    del sd
    if quantize in ("int8", "int8-all"):
        from .models.quant import calibrate_vit_act_scales, quantize_lm_int8, quantize_vit_int8

        params["lm"] = quantize_lm_int8(params["lm"])
        if quantize == "int8-all":
            for tower, px in zip(("siglip", "dino"), calib_pixels or (None, None)):
                scales = None if px is None else calibrate_vit_act_scales(
                    getattr(cfg, tower), params[tower],
                    torch.as_tensor(np.asarray(px), device=device), dtype=cfg.dtype)
                params[tower] = quantize_vit_int8(params[tower], act_scales=scales)

    tokenizer = None
    if load_tokenizer:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                "load_tokenizer=True needs the transformers package, which is not installed; "
                "pass load_tokenizer=False and give the predictor a tokenizer with "
                "encode/decode") from e
        tokenizer = AutoTokenizer.from_pretrained(model_path, use_fast=True)

    from .data.images import tower_preprocess_list

    return tokenizer, TDCModel(cfg, params), tower_preprocess_list(cfg), cfg.tokenizer_model_max_length


def load_mm_adapter(params: Any, adapter_path: str, cfg: C.TDCConfig, device=None) -> Any:
    """Overlay an adapter-only artifact onto a base parameter tree (the
    reference's projector-only load path)."""
    put = _to_device(resolve_device(device), cfg.param_dtype)
    sd = from_hf.load_torch_state_dict(adapter_path)
    out = dict(params)
    out["sva"] = from_hf.convert_sva(sd, num_towers=2, num_groups=cfg.sva.num_query_group,
                                     depth=cfg.sva.connector_depth, prefix="model.", put=put)
    if "model.image_newline" in sd:
        out["image_newline"] = put(sd["model.image_newline"])
    return out
