"""The training entry point, `python -m tdc_video_tpu_torch.train.run`,
against JAX's `tdc_video_tpu.train.run` on the CPU: both train stage 3
(audio-visual LoRA) from one tiny checkpoint on one data.json (.npy videos
with a wav each, a row with a wav and no video), then a second call of each resumes from
its checkpoint and trains on.  Held: the metrics.jsonl losses within 3e-4
and every tensor of final/model.safetensors within 3e-4, after each call.

Both run in f32 (the checkpoint's config reads as bf16 compute, where the
two frameworks round differently: read_config is wrapped to f32 in both),
on one device (JAX's auto mesh would spread the batch over the 8 virtual
CPU devices of tests/conftest.py), and with the same adapters (the port's
init_lora is wrapped to return JAX's, bridged through numpy, as the JAX
trainer draws them from tcfg.seed)."""

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
from tdc_video_tpu import model as jm
from tdc_video_tpu.train import lora as jlora
from tdc_video_tpu.train import run as jrun
from tdc_video_tpu.train import trainer as jtr
from tdc_video_tpu_torch import builder as tbuilder
from tdc_video_tpu_torch.convert.from_hf import read_safetensors
from tdc_video_tpu_torch.convert.to_hf import save_checkpoint_dir
from tdc_video_tpu_torch.train import lora as tlora
from tdc_video_tpu_torch.train import run as trun
from test_torch_dataset import write_wav
from torch_parity import to_torch


def write_offline_tokenizer(ckpt_dir):
    """A transformers-loadable WordLevel tokenizer beside the checkpoint, so
    that AutoTokenizer.from_pretrained(model_path) needs no network; ids
    below tdc_tiny's vocabulary of 512 (as tests/test_multiprocess.py
    writes one)."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit

    words = ("You are a helpful assistant . ? ! What color is the video first frame red blue "
             "green square describe Describe shown answer with one word scene briefly moving "
             "shapes user system It looks like").split()
    vocab = {"[UNK]": 3}
    for i, w in enumerate(dict.fromkeys(words)):
        vocab[w] = 10 + i
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = WhitespaceSplit()
    tok.add_special_tokens(["<|im_start|>", "<|im_end|>"])
    tok.save(os.path.join(ckpt_dir, "tokenizer.json"))
    with open(os.path.join(ckpt_dir, "tokenizer_config.json"), "w") as fh:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 512,
                   "padding_side": "right"}, fh)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("run")
    cfg = jc.tdc_tiny(audio=True)
    ckpt = str(root / "ckpt")
    save_checkpoint_dir(to_torch(jm.init_tdc(jax.random.PRNGKey(0), cfg)), cfg, ckpt)
    write_offline_tokenizer(ckpt)
    rng = np.random.default_rng(1)
    rows = []
    for i in range(6):
        row = {"conversations": [
            {"from": "human", "value": "<image>\nWhat color is the square ?"},
            {"from": "gpt", "value": "It looks like red ." if i % 2 else "blue square ."}]}
        # every row has a wav: JAX's jitted step takes one batch layout, and
        # a batch without audio keys after one with them fails there
        write_wav(str(root / f"v{i}.wav"), 4.5 + i, seed=i)
        row["audio"] = f"v{i}.wav"
        if i != 3:
            np.save(root / f"v{i}.npy", rng.integers(0, 256, (5 + i, 32, 40, 3), dtype=np.uint8))
            row["video"] = f"v{i}.npy"
        else:
            row["conversations"][0]["value"] = "Describe a scene briefly ."
        rows.append(row)
    with open(root / "data.json", "w") as fh:
        json.dump(rows, fh)
    return root


def _f32(read_config, f32):
    return lambda path: dataclasses.replace(read_config(path), dtype=f32, compress_dtype=f32)


@pytest.fixture
def both_f32(monkeypatch):
    monkeypatch.setenv("TDC_DISABLE_JAX_CACHE", "1")
    monkeypatch.setattr(jbuilder, "read_config", _f32(jbuilder.read_config, jnp.float32))
    monkeypatch.setattr(tbuilder, "read_config", _f32(tbuilder.read_config, torch.float32))
    monkeypatch.setattr(jtr, "auto_mesh_shape", lambda n, kv: (1, 1))

    def jax_adapters(params, rank=128, generator=None, **kw):
        lm = jax.tree_util.tree_map(lambda x: jnp.asarray(x.detach().numpy()), params)
        return to_torch(jlora.init_lora(jax.random.PRNGKey(42), lm, rank))

    assert jtr.TrainConfig().seed == 42
    monkeypatch.setattr(tlora, "init_lora", jax_adapters)


def _args(root, out, max_steps):
    return ["--stage", "3", "--model_path", str(root / "ckpt"), "--data_path", str(root / "data.json"),
            "--image_folder", str(root), "--output_dir", str(out), "--bert_tokenizer", "",
            "--max_steps", str(max_steps), "--report_to", "jsonl", "--learning_rate", "1e-2",
            "--max_train_frames", "8", "--model_max_length", "256"]


def _losses(out):
    return [json.loads(x)["loss"] for x in open(os.path.join(out, "metrics.jsonl"))]


def _final_close(port_out, jax_out):
    a = read_safetensors(os.path.join(port_out, "final", "model.safetensors"))
    b = read_safetensors(os.path.join(jax_out, "final", "model.safetensors"))
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), atol=3e-4, rtol=3e-4,
                                   err_msg=k)
    return {k: np.array(v) for k, v in a.items()}  # copies: the next call rewrites the file


def test_train_run_stage3_matches_jax_and_resumes(workdir, both_f32, capsys):
    jout, tout = workdir / "out_jax", workdir / "out_port"
    jrun.main(_args(workdir, jout, 2))
    trainer = trun.main(_args(workdir, tout, 2) + ["--device", "cpu"])
    assert trainer.step == 2 and trainer.tx.count == 1 and trainer.lora is not None
    assert os.path.exists(tout / "checkpoints" / "2" / "state.safetensors")
    np.testing.assert_allclose(_losses(tout), _losses(jout), atol=3e-4, rtol=3e-4)
    assert len(_losses(tout)) == 2
    first = _final_close(tout, jout)
    loaded = tbuilder.load_pretrained_model(str(tout / "final"), load_tokenizer=False,
                                            device="cpu")[1]
    assert loaded.cfg.audio_input and loaded.params["lm"]["layers"]["q_proj"]["w"].dtype == torch.float32

    capsys.readouterr()
    jrun.main(_args(workdir, jout, 6))
    assert "resumed at step 2" in capsys.readouterr().out
    trainer = trun.main(_args(workdir, tout, 6) + ["--device", "cpu"])
    assert "resumed at step 2" in capsys.readouterr().out
    assert trainer.step == 6 and trainer.tx.count == 2
    losses = _losses(tout)
    assert len(losses) == 6 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, _losses(jout), atol=3e-4, rtol=3e-4)
    second = _final_close(tout, jout)
    # the second call's second update (lr > 0 after the warmup) moved the
    # adapters and the trainable extras into the merged weights
    name = "model.layers.0.self_attn.q_proj.weight"
    assert not np.array_equal(second[name], first[name])
