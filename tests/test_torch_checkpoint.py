"""Checkpoint I/O of the port against the JAX package, on tdc_tiny.

A reference-format checkpoint (tests/test_builder.py::write_checkpoint) is
read by both packages: the converted trees must be equal bit for bit, as
must the exported state dicts and config.json files; the port's own
safetensors reader and writer are held to the safetensors library; and a
checkpoint loaded by each package must answer with the same tokens, on both
preprocessing paths.  Weights are stored f32 here, so every comparison of
weights is exact (tolerance 0); prepare_pos_embed is held at the golden
tolerance 3e-4.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import builder as jbuilder
from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.convert import from_hf as jfrom_hf
from tdc_video_tpu.convert import to_hf as jto_hf
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.models import vit as jvit
from tdc_video_tpu_torch import builder as tbuilder
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.convert import from_hf as tfrom_hf
from tdc_video_tpu_torch.convert import to_hf as tto_hf
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.models import vit as tvit
from test_builder import write_checkpoint
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer, close, to_torch

# the dtypes safetensors.numpy reads, as the port's reader must
DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64, "I64": np.int64,
          "I32": np.int32, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def assert_trees_equal(port, ref, path="params"):
    """Same structure (dict keys, list lengths, None leaves) and every leaf
    bitwise equal, dtype included."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(port) == sorted(ref), path
        for k in ref:
            assert_trees_equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_trees_equal(a, b, f"{path}[{i}]")
    elif ref is None:
        assert port is None, path
    else:
        a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
        b = np.asarray(ref)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tdc-tiny")
    write_checkpoint(path, jc.tdc_tiny(), audio=False)
    return path


def test_convert_tdc_bitwise(ckpt):
    ref = jfrom_hf.convert_tdc(jbuilder.load_state_dict(ckpt), jbuilder.read_config(ckpt))
    out = tfrom_hf.convert_tdc(tbuilder.load_state_dict(ckpt), tbuilder.read_config(ckpt))
    assert_trees_equal(out, ref)


def test_read_config_matches_jax(ckpt):
    ref, out = jbuilder.read_config(ckpt), tbuilder.read_config(ckpt)
    for section in ("lm", "siglip", "dino", "qformer", "beats", "sva", "compression"):
        assert dataclasses.asdict(getattr(out, section)) == dataclasses.asdict(getattr(ref, section)), section
    for f in ("conv_version", "tokenizer_model_max_length", "inference_max_length", "video_fps",
              "audio_input"):
        assert getattr(out, f) == getattr(ref, f), f


def test_export_tdc_bitwise_and_config(tmp_path):
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    tp = to_torch(jp)
    ref = jto_hf.export_tdc(jp, jc.tdc_tiny())
    out = tto_hf.export_tdc(tp, tc.tdc_tiny())
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    jto_hf.save_checkpoint_dir(jp, jc.tdc_tiny(), str(tmp_path / "jax"))
    tto_hf.save_checkpoint_dir(tp, tc.tdc_tiny(), str(tmp_path / "port"))
    cfgs = [json.load(open(tmp_path / d / "config.json")) for d in ("jax", "port")]
    assert cfgs[1] == cfgs[0]
    # each package reads the other's file into the same tree
    back = jfrom_hf.convert_tdc(jfrom_hf.load_torch_state_dict(str(tmp_path / "port" / "model.safetensors")),
                                jc.tdc_tiny())
    assert_trees_equal(back, jax.tree_util.tree_map(np.asarray, jp))


def _library_tensors():
    rng = np.random.default_rng(0)
    out = {}
    for name, dt in DTYPES.items():
        if np.issubdtype(dt, np.floating):
            out[name] = (rng.normal(size=(3, 5)) * 50).astype(dt)
        elif dt is np.bool_:
            out[name] = rng.random((4, 3)) > 0.5
        else:
            info = np.iinfo(dt)
            out[name] = rng.integers(info.min, info.max, (2, 7), dtype=dt)
    out["scalar"] = np.asarray(1.5, np.float32)
    out["empty"] = np.zeros((0, 4), np.float32)
    return out


def test_safetensors_reader_reads_library_files(tmp_path):
    from safetensors.numpy import save_file

    tensors = _library_tensors()
    path = str(tmp_path / "lib.safetensors")
    save_file(tensors, path, metadata={"format": "np", "note": "written by the library"})
    assert tfrom_hf._is_safetensors(path)
    out = tfrom_hf.read_safetensors(path)
    assert sorted(out) == sorted(tensors)
    for k, v in tensors.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape, k
        np.testing.assert_array_equal(out[k], v, err_msg=k)


def test_safetensors_writer_read_by_library(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import load_file

    tensors = _library_tensors()
    base = np.arange(24, dtype=np.float32).reshape(4, 6)
    tensors["transposed"] = base.T  # a view: its bytes must be the transpose's
    path = str(tmp_path / "port.safetensors")
    tto_hf.save_safetensors(tensors, path, metadata={"format": "np"})
    back = load_file(path)
    assert sorted(back) == sorted(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    with safe_open(path, framework="np") as fh:
        assert fh.metadata() == {"format": "np"}
    # and the port's reader reads its own file back
    out = tfrom_hf.read_safetensors(path)
    np.testing.assert_array_equal(out["transposed"], base.T)


@pytest.fixture(scope="module")
def audio_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("audio") / "tdc-tiny-audio")
    write_checkpoint(path, jc.tdc_tiny(audio=True), audio=True)
    return path


def test_audio_checkpoint_converts_bitwise(audio_ckpt):
    """An audio-visual checkpoint (BEATs under audio_encoder.beats., and
    audio_proj): the config reads back at the checkpoint's own BEATs dims,
    convert_tdc gives JAX's tree bit for bit, beats and audio_proj
    included, and load_pretrained_model puts the same weights on the
    device."""
    ref_cfg, cfg = jbuilder.read_config(audio_ckpt), tbuilder.read_config(audio_ckpt)
    assert cfg.audio_input and cfg.compression.audio_input
    for section in ("beats", "compression"):
        assert dataclasses.asdict(getattr(cfg, section)) == dataclasses.asdict(getattr(ref_cfg, section))
    assert dataclasses.asdict(cfg.beats) == dataclasses.asdict(tc.BEATS_TINY)
    ref = jfrom_hf.convert_tdc(jbuilder.load_state_dict(audio_ckpt), ref_cfg)
    out = tfrom_hf.convert_tdc(tbuilder.load_state_dict(audio_ckpt), cfg)
    assert "beats" in out and "audio_proj" in out
    assert_trees_equal(out, ref)
    _, model, _, _ = tbuilder.load_pretrained_model(audio_ckpt, load_tokenizer=False, device="cpu")
    assert_trees_equal(model.params, ref)


def test_convert_and_export_beats_bitwise():
    """convert_beats (the weight-normed pos_conv folded) and export_beats on
    a reference-layout BEATs state dict, against JAX's."""
    from test_convert import make_beats_sd

    sd = make_beats_sd(jc.BEATS_TINY, prefix="audio_encoder.beats.")
    ref = jfrom_hf.convert_beats(sd, jc.BEATS_TINY, prefix="audio_encoder.beats.")
    out = tfrom_hf.convert_beats(sd, tc.BEATS_TINY, prefix="audio_encoder.beats.")
    assert_trees_equal(out, ref)
    ref_sd = jto_hf.export_beats(ref, "audio_encoder.beats.")
    out_sd = tto_hf.export_beats(to_torch(ref), "audio_encoder.beats.")
    assert sorted(out_sd) == sorted(ref_sd) == sorted(sd)
    for k in ref_sd:
        assert out_sd[k].dtype == ref_sd[k].dtype and out_sd[k].shape == ref_sd[k].shape, k
        np.testing.assert_array_equal(out_sd[k], ref_sd[k], err_msg=k)


def test_audio_export_and_round_trip(tmp_path):
    """export_tdc of an audio-visual tree equals JAX's bit for bit, and
    save_checkpoint_dir + load_pretrained_model give back the audio
    config and the same weights."""
    jcfg, tcfg = jc.tdc_tiny(audio=True), tc.tdc_tiny(audio=True)
    jp = jmodel.init_tdc(jax.random.PRNGKey(4), jcfg)
    tp = to_torch(jp)
    ref = jto_hf.export_tdc(jp, jcfg)
    out = tto_hf.export_tdc(tp, tcfg)
    assert sorted(out) == sorted(ref)
    assert any(k.startswith("model.audio_encoder.beats.") for k in out) and "model.audio_proj.weight" in out
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    path = str(tmp_path / "port")
    tto_hf.save_checkpoint_dir(tp, tcfg, path)
    _, model, _, _ = tbuilder.load_pretrained_model(path, load_tokenizer=False,
                                                    dtype=torch.float32, device="cpu")
    # config.json keeps the BEATs dims and the audio switches (not every
    # tdc_tiny field: the SVA's head count and the compression caps are
    # not written)
    assert model.cfg.beats == tcfg.beats and model.cfg.lm == tcfg.lm
    assert model.cfg.audio_input and model.cfg.compression.audio_input
    assert_trees_equal(model.params, jax.tree_util.tree_map(np.asarray, jp))


def test_quantize_raises(ckpt):
    """quantize="int8" loads the LM as JAX's loader quantizes it (w_q
    bitwise, int8), the towers float; an unknown mode raises ValueError."""
    _, jm, _, _ = jbuilder.load_pretrained_model(ckpt, load_tokenizer=False, quantize="int8")
    _, tm, _, _ = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, quantize="int8",
                                                 device="cpu")
    assert tm.params["lm"]["layers"]["q_proj"]["w_q"].dtype == torch.int8
    assert "w" in tm.params["siglip"]["layers"]["q_proj"]
    for name in ("q_proj", "o_proj"):
        np.testing.assert_array_equal(tm.params["lm"]["layers"][name]["w_q"].numpy(),
                                      np.asarray(jm.params["lm"]["layers"][name]["w_q"]))
    with pytest.raises(ValueError, match="int4"):
        tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, quantize="int4", device="cpu")


def test_merge_lora_matches_jax():
    rng = np.random.default_rng(21)
    sd = {f"model.layers.{i}.self_attn.q_proj.weight": rng.normal(size=(8, 6)).astype(np.float32)
          for i in range(2)}
    sd["model.frame_seg"] = rng.normal(size=(6,)).astype(np.float32)
    adapter = {}
    for i in range(2):
        k = f"base_model.model.model.layers.{i}.self_attn.q_proj"
        adapter[k + ".lora_A.weight"] = rng.normal(0, 0.1, (2, 6)).astype(np.float32)
        adapter[k + ".lora_B.weight"] = rng.normal(0, 0.1, (8, 2)).astype(np.float32)
    adapter["base_model.model.model.frame_seg"] = rng.normal(size=(6,)).astype(np.float32)
    acfg = {"r": 2, "lora_alpha": 8}
    ref = jbuilder.merge_lora(sd, adapter, adapter_config=acfg)
    out = tbuilder.merge_lora(sd, adapter, adapter_config=acfg)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("src,dst", [(37, 27), (27, 37), (6, 4)])
def test_prepare_pos_embed_matches_jax(src, dst):
    """The DINOv2 position grid resized from a checkpoint's grid (518 px is
    37x37) to the config's (378 px is 27x27), and back up, at the golden
    tolerance 3e-4."""
    jcfg = dataclasses.replace(jc.VIT_TINY_DINO, image_size=dst * 14, hidden_size=8)
    tcfg = dataclasses.replace(tc.VIT_TINY_DINO, image_size=dst * 14, hidden_size=8)
    pos = np.random.default_rng(src).normal(size=(src * src + 1, 8)).astype(np.float32)
    ref = jvit.prepare_pos_embed({"pos_embed": jnp.asarray(pos)}, jcfg)["pos_embed"]
    out = tvit.prepare_pos_embed({"pos_embed": torch.from_numpy(pos)}, tcfg)["pos_embed"]
    assert out.shape == (dst * dst + 1, 8)
    close(out, ref)


def _frames():
    frames = np.random.default_rng(3).integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    frames[3:, :, :32] = 255 - frames[3:, :, :32]
    return frames


@pytest.mark.parametrize("device_preprocess", [False, True], ids=["host", "device"])
def test_answer_from_checkpoint_token_identical(ckpt, device_preprocess):
    """Each package loads the checkpoint and answers; f32 compute and an f32
    compressor, as the other token-identity tests (test_torch_e2e.py)."""
    _, jm, _, jctx = jbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=jnp.float32)
    _, tm, _, tctx = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=torch.float32,
                                                    device="cpu")
    assert tctx == jctx
    assert_trees_equal(tm.params, jax.tree_util.tree_map(np.asarray, jm.params))
    jcfg = dataclasses.replace(jm.cfg, compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.cfg, compress_dtype=torch.float32)
    jpred = JaxPredictor(jcfg, jm.params, JaxStubTokenizer(), max_new_tokens=8, text_bucket=128,
                         device_preprocess=device_preprocess)
    tpred = TorchPredictor(tcfg, tm.params, StubTokenizer(), max_new_tokens=8, text_bucket=128,
                           device_preprocess=device_preprocess, device="cpu")
    frames = _frames()
    for question in ("What happens?", "Which color is on the left?"):
        ref = jpred.answer(frames, question, video_uid="clip")
        out = tpred.answer(frames, question, video_uid="clip")
        assert out == ref
        assert out == StubTokenizer().decode(tpred.stats.last_ids)


def test_feature_cache_keyed_on_video_uid(ckpt):
    """answer(video_uid=...) encodes a video once; without a uid it encodes
    every call."""
    _, tm, _, _ = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=torch.float32,
                                                 device="cpu")
    pred = TorchPredictor(tm.cfg, tm.params, StubTokenizer(), max_new_tokens=2, text_bucket=128,
                          device="cpu")
    calls = []
    encode = pred.encode_video
    pred.encode_video = lambda frames, cache_key=None: calls.append(cache_key) or encode(frames, cache_key)
    frames = _frames()
    first = pred.answer(frames, "What happens?", video_uid="a")
    cached = pred._feat_cache[1]
    assert pred.answer(frames, "What happens?", video_uid="a") == first
    assert pred._feat_cache[1] is cached
    pred.answer(frames, "What happens?")
    assert pred._feat_cache[1] is cached  # no uid: nothing stored
    assert [c[0] if c else None for c in calls] == ["a", "a", None]


def test_load_mm_adapter_matches_jax(ckpt, tmp_path):
    _, jm, _, _ = jbuilder.load_pretrained_model(ckpt, load_tokenizer=False)
    _, tm, _, _ = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, device="cpu")
    donor = jmodel.init_tdc(jax.random.PRNGKey(9), jm.cfg)
    path = str(tmp_path / "mm_projector.bin")
    tto_hf.save_mm_adapter(to_torch(donor), path)
    ref = jbuilder.load_mm_adapter(jm.params, path, jm.cfg)
    out = tbuilder.load_mm_adapter(tm.params, path, tm.cfg, device="cpu")
    assert_trees_equal(out, jax.tree_util.tree_map(np.asarray, ref))


def test_lora_checkpoint_matches_jax(tmp_path):
    """The loader's LoRA flavour (a base checkpoint, a peft adapter in
    safetensors, non-LoRA trainables in a torch .bin) gives the JAX
    loader's tree, bit for bit."""
    import shutil

    from safetensors.numpy import save_file

    cfg = jc.tdc_tiny()
    base = str(tmp_path / "base")
    base_sd = write_checkpoint(base, cfg)
    rng = np.random.default_rng(21)
    adapter = {}
    for i in range(cfg.lm.num_layers):
        k = f"base_model.model.model.layers.{i}.self_attn.q_proj"
        adapter[k + ".lora_A.weight"] = rng.normal(0, 0.1, (2, cfg.lm.hidden_size)).astype(np.float32)
        adapter[k + ".lora_B.weight"] = rng.normal(0, 0.1, (cfg.lm.q_dim, 2)).astype(np.float32)
    lora = str(tmp_path / "tdc-lora-ft")
    os.makedirs(lora)
    save_file(adapter, os.path.join(lora, "adapter_model.safetensors"))
    seg = rng.normal(size=base_sd["model.frame_seg"].shape).astype(np.float32)
    torch.save({"base_model.model.model.frame_seg": torch.from_numpy(seg)},
               os.path.join(lora, "non_lora_trainables.bin"))
    with open(os.path.join(lora, "adapter_config.json"), "w") as fh:
        json.dump({"r": 2, "lora_alpha": 8}, fh)
    shutil.copy(os.path.join(base, "config.json"), os.path.join(lora, "config.json"))
    _, jm, _, _ = jbuilder.load_pretrained_model(lora, model_base=base, load_tokenizer=False)
    _, tm, _, _ = tbuilder.load_pretrained_model(lora, model_base=base, load_tokenizer=False,
                                                 device="cpu")
    assert_trees_equal(tm.params, jax.tree_util.tree_map(np.asarray, jm.params))
    np.testing.assert_array_equal(tm.params["compressor"]["frame_seg"].numpy(), seg)


def test_bf16_checkpoint_loads_without_widening(ckpt, tmp_path):
    """A bfloat16 checkpoint (written by safetensors.torch): the reader keeps
    its bits under the BF16 tag, numpy leaves widen exactly, and the loader
    gives the f32 checkpoint's weights rounded to bf16, widened exactly to
    the f32 they are kept in."""
    import shutil

    from safetensors.torch import save_file

    sd = tbuilder.load_state_dict(ckpt)
    bf16 = {k: torch.from_numpy(np.array(v)).to(torch.bfloat16) for k, v in sd.items()}
    path = str(tmp_path / "bf16")
    os.makedirs(path)
    save_file(bf16, os.path.join(path, "model.safetensors"))
    shutil.copy(os.path.join(ckpt, "config.json"), os.path.join(path, "config.json"))
    back = tbuilder.load_state_dict(path)
    k = "model.layers.0.self_attn.q_proj.weight"
    assert back[k].dtype == tfrom_hf.BF16 and back[k].shape == sd[k].shape
    np.testing.assert_array_equal(tfrom_hf.widen_bf16(back[k]), bf16[k].float().numpy())
    _, ref, _, _ = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, device="cpu")
    _, out, _, _ = tbuilder.load_pretrained_model(path, load_tokenizer=False, device="cpu")
    assert_trees_equal(out.params, _through_bf16(ref.params))
    # numpy trees (the converters' default) hold the exact f32 values
    tree = tfrom_hf.convert_tdc(back, tbuilder.read_config(path))
    np.testing.assert_array_equal(tree["lm"]["layers"]["q_proj"]["w"][0], bf16[k].float().numpy().T)
    # the port's writer writes the tagged bits back as BF16, a transposed view included
    from safetensors.torch import load_file

    tto_hf.save_safetensors({"w": back[k].T, "b": back["model.norm.weight"]}, str(tmp_path / "w.st"))
    again = load_file(str(tmp_path / "w.st"))
    assert torch.equal(again["w"], bf16[k].T.contiguous())
    assert torch.equal(again["b"], bf16["model.norm.weight"])


def _through_bf16(tree):
    """Float leaves rounded to bf16 and widened back; others unchanged."""
    if isinstance(tree, dict):
        return {k: _through_bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_through_bf16(v) for v in tree]
    if tree is None or not tree.is_floating_point():
        return tree
    return tree.to(torch.bfloat16).to(tree.dtype)
