"""The port's model operations (cli/model_ops.py) against the JAX
package's: merge-lora, make-delta, apply-delta and consolidate on tiny
reference-format checkpoints write state dicts bitwise equal to JAX's
cmd_* on the same inputs (both read back with the port's reader); the
delta rules of tests/test_export.py (a vocabulary-resize slice, a
non-vocabulary mismatch raising, a wrong base raising) on the port's
combine_state_dicts, beside JAX's; bfloat16 inputs; and export-orbax
exiting with its message."""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from tdc_video_tpu.cli import model_ops as jops
from tdc_video_tpu.config import tdc_tiny
from tdc_video_tpu_torch.builder import load_state_dict
from tdc_video_tpu_torch.cli import model_ops as tops
from tdc_video_tpu_torch.convert import from_hf
from tdc_video_tpu_torch.convert.to_hf import save_safetensors
from test_builder import write_checkpoint


def assert_sd_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A base checkpoint; a target with every tensor moved, the embedding
    and the head grown by 3 rows and a new module; the base in two shards;
    a peft LoRA adapter over the base."""
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("ops")
    cfg = tdc_tiny()
    base = str(root / "base")
    base_sd = write_checkpoint(base, cfg)
    rng = np.random.default_rng(3)
    target_sd = {k: (v + rng.normal(0, 0.1, v.shape)).astype(v.dtype) for k, v in base_sd.items()}
    for k in ("model.embed_tokens.weight", "lm_head.weight"):
        if k in target_sd:
            v = target_sd[k]
            target_sd[k] = np.concatenate([v, rng.normal(size=(3,) + v.shape[1:]).astype(v.dtype)])
    target_sd["model.mm_projector.extra.weight"] = rng.normal(size=(4, 4)).astype(np.float32)
    target = str(root / "target")
    os.makedirs(target)
    save_file(target_sd, os.path.join(target, "model.safetensors"))
    shutil.copy(os.path.join(base, "config.json"), os.path.join(target, "config.json"))

    shards = str(root / "shards")
    os.makedirs(shards)
    keys = sorted(base_sd)
    for i, part in enumerate((keys[::2], keys[1::2])):
        save_file({k: base_sd[k] for k in part},
                  os.path.join(shards, f"model-0000{i + 1}-of-00002.safetensors"))

    lora = str(root / "tdc-lora-ft")
    os.makedirs(lora)
    adapter = {}
    for i in range(cfg.lm.num_layers):
        k = f"base_model.model.model.layers.{i}.self_attn.q_proj"
        adapter[k + ".lora_A.weight"] = rng.normal(0, 0.1, (2, cfg.lm.hidden_size)).astype(np.float32)
        adapter[k + ".lora_B.weight"] = rng.normal(0, 0.1, (cfg.lm.q_dim, 2)).astype(np.float32)
    save_file(adapter, os.path.join(lora, "adapter_model.safetensors"))
    with open(os.path.join(lora, "adapter_config.json"), "w") as fh:
        json.dump({"r": 2, "lora_alpha": 8}, fh)
    shutil.copy(os.path.join(base, "config.json"), os.path.join(lora, "config.json"))
    return dict(root=root, base=base, target=target, shards=shards, lora=lora, base_sd=base_sd,
                target_sd=target_sd)


OUT = object()  # the argument that names the command's output directory


def _both(ckpts, name, fn, **args):
    """Run JAX's and the port's command with the same inputs into their own
    output directories; returns their written state dicts."""
    out = {}
    for pkg, mod in (("jax", jops), ("port", tops)):
        out[pkg] = str(ckpts["root"] / f"{name}-{pkg}")
        kw = {k: (out[pkg] if v is OUT else v) for k, v in args.items()}
        getattr(mod, fn)(types.SimpleNamespace(**kw, device="cpu"))
    return load_state_dict(out["jax"]), load_state_dict(out["port"]), out


def test_make_and_apply_delta_equal_jax(ckpts):
    jd, td, dirs = _both(ckpts, "delta", "cmd_make_delta", base=ckpts["base"],
                         target=ckpts["target"], delta=OUT)
    assert_sd_equal(td, jd)
    assert os.path.exists(os.path.join(dirs["port"], "config.json"))
    head = "model.embed_tokens.weight"
    np.testing.assert_array_equal(td[head][-3:], ckpts["target_sd"][head][-3:])
    jr, tr, _ = _both(ckpts, "recon", "cmd_apply_delta", base=ckpts["base"], delta=dirs["port"],
                      target=OUT)
    assert_sd_equal(tr, jr)
    for k, v in ckpts["target_sd"].items():
        np.testing.assert_allclose(tr[k], v, rtol=1e-6, atol=1e-6, err_msg=k)


def test_consolidate_equals_jax(ckpts):
    jc_, tc_, _ = _both(ckpts, "consolidated", "cmd_consolidate", src=ckpts["shards"], dst=OUT)
    assert_sd_equal(tc_, jc_)
    assert_sd_equal(tc_, ckpts["base_sd"])


def test_merge_lora_equals_jax(ckpts):
    jm, tm, dirs = _both(ckpts, "merged", "cmd_merge_lora", model_path=ckpts["lora"],
                         model_base=ckpts["base"], model_name=None, save_path=OUT)
    assert_sd_equal(tm, jm)
    k = "model.layers.0.self_attn.q_proj.weight"
    assert not np.array_equal(tm[k], ckpts["base_sd"][k])  # the adapter was merged
    assert os.path.exists(os.path.join(dirs["port"], "config.json"))


def test_cli_main(ckpts):
    out = str(ckpts["root"] / "cli-delta")
    tops.main(["make-delta", "--base", ckpts["base"], "--target", ckpts["target"],
               "--delta", out])
    assert_sd_equal(load_state_dict(out), load_state_dict(str(ckpts["root"] / "delta-jax")))


def test_delta_vocab_resize_slice_combines():
    rng = np.random.default_rng(1)
    base = {"model.embed_tokens.weight": rng.normal(size=(4, 3)).astype(np.float32),
            "lm_head.weight": rng.normal(size=(4, 3)).astype(np.float32)}
    target = {"model.embed_tokens.weight": rng.normal(size=(6, 3)).astype(np.float32),
              "lm_head.weight": rng.normal(size=(6, 3)).astype(np.float32),
              "model.mm_projector.weight": rng.normal(size=(3, 3)).astype(np.float32)}
    delta = tops.combine_state_dicts(target, base, sign=-1)
    assert_sd_equal(delta, jops.combine_state_dicts(target, base, sign=-1))
    recon = tops.combine_state_dicts(delta, base, sign=+1)
    for k in target:
        np.testing.assert_allclose(recon[k], target[k], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(delta["lm_head.weight"][4:], target["lm_head.weight"][4:])


def test_delta_non_vocab_mismatch_raises():
    base = {"model.layers.0.mlp.weight": np.zeros((4, 4), np.float32)}
    bad = {"model.layers.0.mlp.weight": np.ones((8, 4), np.float32)}
    for mod in (tops, jops):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.combine_state_dicts(bad, base, sign=+1)


def test_delta_wrong_base_raises():
    delta = {f"model.layers.{i}.weight": np.ones((2, 2), np.float32) for i in range(4)}
    wrong_base = {"different.naming.weight": np.ones((2, 2), np.float32)}
    for mod in (tops, jops):
        with pytest.raises(ValueError, match="missing from base"):
            mod.combine_state_dicts(delta, wrong_base, sign=+1)
    extra = dict(delta, **{"model.mm_projector.weight": np.ones((2, 2), np.float32)})
    out = tops.combine_state_dicts(extra, dict(delta), sign=-1)
    assert "model.mm_projector.weight" in out
    assert_sd_equal(out, jops.combine_state_dicts(extra, dict(delta), sign=-1))


def test_bf16_checkpoints_combine_their_exact_values(tmp_path):
    """The port's reader keeps bfloat16 tensors under their BF16 tag; the
    delta combines their exact (widened) values in f32."""
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)).to(torch.bfloat16)
    for name, x in (("base", b), ("target", t)):
        os.makedirs(tmp_path / name)
        save_safetensors({"model.x.weight": x.view(torch.int16).numpy().view(from_hf.BF16)},
                         str(tmp_path / name / "model.safetensors"))
    assert load_state_dict(str(tmp_path / "base"))["model.x.weight"].dtype == from_hf.BF16
    tops.main(["make-delta", "--base", str(tmp_path / "base"), "--target",
               str(tmp_path / "target"), "--delta", str(tmp_path / "delta")])
    got = load_state_dict(str(tmp_path / "delta"))["model.x.weight"]
    np.testing.assert_array_equal(got, t.float().numpy() - b.float().numpy())


def test_export_orbax_exits_with_its_message(tmp_path):
    with pytest.raises(SystemExit, match="reads no Orbax") as e:
        tops.main(["export-orbax", "--orbax_dir", str(tmp_path), "--config_dir", str(tmp_path),
                   "--save_path", str(tmp_path / "out")])
    assert "export_merged" in str(e.value)
    assert not os.path.exists(tmp_path / "out")
