"""Config dataclasses (port of tdc_video_tpu/config.py).

Field names are the JAX package's; `dtype`, `param_dtype` and
`compress_dtype` are torch dtypes.  Each preset takes `audio=True` for its
audio-visual variant (BEATs + audio_proj, 50 audio tokens fused into each
chunk's static frame).  `save_config` / `load_config` write and read the
JAX package's JSON: a dtype is written by its JAX name ("bfloat16").
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer config (Qwen2 and Llama-3.x)."""

    name: str = "qwen2"
    vocab_size: int = 152064
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    intermediate_size: int = 18944
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    # Llama-3 rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None disables.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attention_bias: bool = True
    pad_token_id: int = 151643
    eos_token_ids: Tuple[int, ...] = (151645, 151643)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


QWEN2_7B = LMConfig()

LLAMA32_3B = LMConfig(
    name="llama",
    vocab_size=128256,
    hidden_size=3072,
    num_layers=28,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=8192,
    rms_norm_eps=1e-5,
    rope_theta=500000.0,
    rope_scaling=(32.0, 1.0, 4.0, 8192),
    max_position_embeddings=131072,
    tie_word_embeddings=True,
    attention_bias=False,
    pad_token_id=128002,
    eos_token_ids=(128009, 128001),
)

LM_TINY = LMConfig(
    name="qwen2",
    vocab_size=512,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    intermediate_size=128,
    max_position_embeddings=512,
    pad_token_id=0,
    eos_token_ids=(1,),
)


@dataclass(frozen=True)
class ViTConfig:
    """ViT encoder config serving SigLIP and DINOv2."""

    name: str = "siglip"
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    layer_norm_eps: float = 1e-6
    use_cls_token: bool = False
    use_swiglu: bool = False
    layerscale: bool = False
    interp_tokens: int = 576

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


SIGLIP_SO400M = ViTConfig()

DINOV2_GIANT = ViTConfig(
    name="dinov2",
    image_size=378,
    patch_size=14,
    hidden_size=1536,
    num_layers=40,
    num_heads=24,
    intermediate_size=4096,
    use_cls_token=True,
    use_swiglu=True,
    layerscale=True,
)

VIT_TINY = ViTConfig(
    name="siglip",
    image_size=56,
    patch_size=14,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    intermediate_size=64,
    interp_tokens=16,
)

VIT_TINY_DINO = ViTConfig(
    name="dinov2",
    image_size=56,
    patch_size=14,
    hidden_size=48,
    num_layers=2,
    num_heads=2,
    intermediate_size=96,
    use_cls_token=True,
    use_swiglu=True,
    layerscale=True,
    interp_tokens=16,
)


@dataclass(frozen=True)
class QFormerConfig:
    """BERT-with-cross-attention compressor."""

    vocab_size: int = 30523
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    cross_attention_freq: int = 2
    encoder_width: int = 3584
    query_length: int = 16


QFORMER_BASE = QFormerConfig()

QFORMER_TINY = QFormerConfig(
    vocab_size=128,
    hidden_size=32,
    num_layers=4,
    num_heads=2,
    intermediate_size=64,
    max_position_embeddings=64,
    encoder_width=64,
    query_length=4,
)


@dataclass(frozen=True)
class BeatsConfig:
    """BEATs audio transformer dimensions (models/beats.py)."""

    embed_dim: int = 512  # patch-embed conv output
    encoder_embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    fbank_bins: int = 128
    patch_size: int = 16
    conv_bias: bool = False
    layer_norm_first: bool = False
    deep_norm: bool = True
    gru_rel_pos: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    dropout: float = 0.0
    fbank_mean: float = 15.41663
    fbank_std: float = 6.55582


BEATS_BASE = BeatsConfig()

BEATS_TINY = BeatsConfig(
    embed_dim=16,
    encoder_embed_dim=32,
    num_layers=2,
    num_heads=2,
    ffn_dim=64,
    num_buckets=32,
    max_distance=64,
)


@dataclass(frozen=True)
class SVAConfig:
    """Spatial Vision Aggregator."""

    vision_hidden_size: int = 1024
    num_query_group: int = 1
    query_num_list: Tuple[int, ...] = (576,)
    connector_depth: int = 3
    image_token_len: int = 576
    num_heads: int = 16
    tower_token_len_list: Tuple[int, ...] = (576, 576)
    connector_only: bool = True

    @property
    def query_side_len(self) -> int:
        return int(self.query_num_list[0] ** 0.5)

    @property
    def final_side_len(self) -> int:
        return int(self.image_token_len**0.5)


SVA_DEFAULT = SVAConfig()
SVA_VIDEO = SVAConfig(query_num_list=(144,), image_token_len=144)
SVA_TINY = SVAConfig(
    vision_hidden_size=32,
    query_num_list=(16,),
    image_token_len=16,
    num_heads=2,
    tower_token_len_list=(16, 16),
)


@dataclass(frozen=True)
class CompressionConfig:
    """Temporal Dynamic Context compression knobs."""

    context_token_num: int = 16
    max_num_segments: int = 24
    chunk_size: int = 8
    query_type: str = "Avg_pool"  # or "learned"
    add_static: bool = True
    text_input: bool = True
    add_sep: bool = True
    audio_input: bool = False
    dino_threshold: float = 0.83
    dino_window_size: int = 64
    max_train_frames: int = 224
    max_eval_frames: int = 1000
    frame_pos: bool = False
    is_image_newline: bool = True
    qformer_text_max_len: int = 256


@dataclass(frozen=True)
class TDCConfig:
    """Everything needed to build a TDC-Video model."""

    lm: LMConfig = QWEN2_7B
    siglip: ViTConfig = SIGLIP_SO400M
    dino: ViTConfig = DINOV2_GIANT
    qformer: QFormerConfig = QFORMER_BASE
    beats: BeatsConfig = BEATS_BASE
    sva: SVAConfig = SVA_DEFAULT
    compression: CompressionConfig = CompressionConfig()

    conv_version: str = "qwen"
    tokenizer_model_max_length: int = 8192
    inference_max_length: int = 16
    video_fps: float = 1.0
    audio_input: bool = False

    # params kept in param_dtype, compute in dtype, reductions f32
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    # Q-Former compression compute dtype
    compress_dtype: Any = torch.bfloat16

    def with_audio(self) -> "TDCConfig":
        return _replace(self, audio_input=True,
                        compression=_replace(self.compression, audio_input=True))

    @property
    def image_token_len(self) -> int:
        return self.sva.image_token_len

    def tokens_per_frame(self) -> int:
        k = self.compression.context_token_num
        n = self.compression.chunk_size
        if not self.compression.add_static:
            return k
        static = self.sva.image_token_len + (50 if self.audio_input else 0)
        return (static + k * (n - 1)) // n


def tdc_qwen2_7b(audio: bool = False) -> TDCConfig:
    """Video flagship (TDC-Qwen2-7B): 144-token SVA grid."""
    cfg = TDCConfig(
        lm=QWEN2_7B,
        sva=SVA_VIDEO,
        qformer=_replace(QFORMER_BASE, encoder_width=QWEN2_7B.hidden_size),
        conv_version="qwen",
    )
    return cfg.with_audio() if audio else cfg


def tdc_llama32_3b(audio: bool = False) -> TDCConfig:
    cfg = TDCConfig(
        lm=LLAMA32_3B,
        sva=SVA_VIDEO,
        qformer=_replace(QFORMER_BASE, encoder_width=LLAMA32_3B.hidden_size),
        conv_version="llama3_2",
    )
    return cfg.with_audio() if audio else cfg


def tdc_qwen2_7b_stage1(audio: bool = False) -> TDCConfig:
    """Stage-1 image alignment config: 576-token grid
    (scripts/stage1/train_image_qwen.sh:46-51)."""
    cfg = TDCConfig(
        lm=QWEN2_7B,
        sva=SVA_DEFAULT,
        qformer=_replace(QFORMER_BASE, encoder_width=QWEN2_7B.hidden_size),
        conv_version="qwen",
    )
    return cfg.with_audio() if audio else cfg


def tdc_tiny(audio: bool = False) -> TDCConfig:
    """Tiny end-to-end config for tests: every module, toy sizes."""
    cfg = TDCConfig(
        lm=LM_TINY,
        siglip=VIT_TINY,
        dino=VIT_TINY_DINO,
        qformer=_replace(QFORMER_TINY, encoder_width=LM_TINY.hidden_size, query_length=4),
        beats=BEATS_TINY,
        sva=SVA_TINY,
        compression=CompressionConfig(
            context_token_num=4,
            max_num_segments=4,
            chunk_size=4,
            max_train_frames=16,
            max_eval_frames=16,
        ),
        tokenizer_model_max_length=512,
        dtype=torch.float32,
    )
    return cfg.with_audio() if audio else cfg


# a dtype's name in the JAX package's JSON, and back
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def save_config(cfg: TDCConfig, path: str) -> None:
    """cfg as the JAX package's save_config writes it: every field, nested
    configs as objects, dtypes by name, tuples as lists."""

    def enc(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return {k: enc(v) for k, v in dataclasses.asdict(o).items()}
        if isinstance(o, torch.dtype) and o in _DTYPE_NAMES:
            return _DTYPE_NAMES[o]
        return o

    d = {f.name: enc(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    with open(path, "w") as fh:
        json.dump(d, fh, indent=2, default=str)


def load_config(path: str) -> TDCConfig:
    """A config written by save_config (the port's or the JAX package's),
    read as the JAX package's load_config reads it: unknown keys ignored,
    lists made tuples, and compress_dtype left at its default (JAX does not
    read it back)."""
    with open(path) as fh:
        d = json.load(fh)

    def mk(cls, dd):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in dd.items() if k in names})

    return TDCConfig(
        lm=mk(LMConfig, d["lm"]),
        siglip=mk(ViTConfig, d["siglip"]),
        dino=mk(ViTConfig, d["dino"]),
        qformer=mk(QFormerConfig, d["qformer"]),
        beats=mk(BeatsConfig, d["beats"]),
        sva=mk(SVAConfig, d["sva"]),
        compression=mk(CompressionConfig, d["compression"]),
        conv_version=d.get("conv_version", "qwen"),
        tokenizer_model_max_length=d.get("tokenizer_model_max_length", 8192),
        inference_max_length=d.get("inference_max_length", 16),
        video_fps=d.get("video_fps", 1.0),
        audio_input=d.get("audio_input", False),
        dtype=_DTYPES.get(str(d.get("dtype", "bfloat16")), torch.bfloat16),
        param_dtype=_DTYPES.get(str(d.get("param_dtype", "float32")), torch.float32),
    )
