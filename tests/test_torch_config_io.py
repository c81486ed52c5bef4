"""The port's config file (config.save_config / load_config) against the JAX
package's: the file the port writes is JSON-equal to JAX's for every
preset, a file JAX writes loads in the port to the fields JAX's
load_config reads (compress_dtype left at its default, as JAX leaves it),
and the port reads back its own file; the stage-1 preset's fields."""

import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu_torch import config as tc

PRESETS = ["tdc_qwen2_7b", "tdc_llama32_3b", "tdc_qwen2_7b_stage1", "tdc_tiny"]
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32, jnp.float16: torch.float16}


def _fields(cfg):
    """A config's fields as a nested dict, JAX's dtypes as the port's (the
    two packages' dataclasses are different classes)."""
    d = dataclasses.asdict(cfg)
    for f in ("dtype", "param_dtype", "compress_dtype"):
        d[f] = DTYPES.get(d[f], d[f])
    return d


@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_port_file_is_jax_file(tmp_path, preset, audio):
    jc.save_config(getattr(jc, preset)(audio), tmp_path / "jax.json")
    tc.save_config(getattr(tc, preset)(audio), tmp_path / "port.json")
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert want["dtype"] in ("bfloat16", "float32")


@pytest.mark.parametrize("audio", [False, True])
@pytest.mark.parametrize("preset", PRESETS)
def test_jax_file_loads_in_port(tmp_path, preset, audio):
    """Both directions: JAX's file read by the port gives the fields JAX's
    load_config gives (dtypes mapped), and the port's file read by JAX gives
    JAX's preset back."""
    jc.save_config(getattr(jc, preset)(audio), tmp_path / "jax.json")
    assert _fields(tc.load_config(tmp_path / "jax.json")) == _fields(jc.load_config(tmp_path / "jax.json"))
    tc.save_config(getattr(tc, preset)(audio), tmp_path / "port.json")
    assert jc.load_config(tmp_path / "port.json") == jc.load_config(tmp_path / "jax.json")
    assert tc.load_config(tmp_path / "port.json") == tc.load_config(tmp_path / "jax.json")


def test_load_leaves_compress_dtype_at_default(tmp_path):
    """JAX's load_config does not read compress_dtype back: an f32
    compressor saved loads as the default bf16 in both packages."""
    cfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32, dtype=torch.bfloat16)
    tc.save_config(cfg, tmp_path / "c.json")
    assert json.loads((tmp_path / "c.json").read_text())["compress_dtype"] == "float32"
    got = tc.load_config(tmp_path / "c.json")
    assert got.compress_dtype == torch.bfloat16 and got.dtype == torch.bfloat16
    assert jc.load_config(tmp_path / "c.json").compress_dtype == jnp.bfloat16
    assert got == dataclasses.replace(cfg, compress_dtype=torch.bfloat16)


def test_unknown_keys_ignored_and_lists_made_tuples(tmp_path):
    tc.save_config(tc.tdc_llama32_3b(), tmp_path / "c.json")
    d = json.loads((tmp_path / "c.json").read_text())
    d["lm"]["not_a_field"] = 1
    d["not_a_field"] = 2
    (tmp_path / "c.json").write_text(json.dumps(d))
    got = tc.load_config(tmp_path / "c.json")
    assert got == tc.tdc_llama32_3b()
    assert isinstance(got.lm.rope_scaling, tuple) and isinstance(got.lm.eos_token_ids, tuple)


@pytest.mark.parametrize("audio", [False, True])
def test_stage1_preset(audio):
    """tdc_qwen2_7b_stage1: Qwen2-7B with the 576-token SVA grid (JAX's
    preset field for field)."""
    cfg = tc.tdc_qwen2_7b_stage1(audio)
    assert _fields(cfg) == _fields(jc.tdc_qwen2_7b_stage1(audio))
    assert cfg.lm == tc.QWEN2_7B and cfg.sva == tc.SVA_DEFAULT and cfg.image_token_len == 576
    assert cfg.qformer.encoder_width == tc.QWEN2_7B.hidden_size and cfg.conv_version == "qwen"
    assert cfg.audio_input == audio and cfg.compression.audio_input == audio
    assert cfg.sva != tc.tdc_qwen2_7b(audio).sva
