"""Port parity of the LoRA Trainer (train/trainer.py with lora_enable) on
tdc_tiny in f32, on the CPU, against the JAX Trainer on the same bridged
params, adapters and batches (QLoRA: test_torch_train_qlora.py).

Tolerances: per-micro-step losses 3e-4, and the adapters and the trainable
extras as test_torch_train._assert_params_close holds them (stated from
lr); export_merged 3e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu.parallel.mesh import make_mesh
from tdc_video_tpu.train import trainer as jtr
from tdc_video_tpu_torch.train import trainer as ttr
from test_torch_train import _assert_params_close, _batch, _cfgs, _port_by_names, jparams  # noqa: F401
from torch_parity import close, to_torch

LR = 1e-3
LORA = dict(lora_enable=True, lora_r=4, lora_alpha=8)


def _kw(tmp_path, **over):
    kw = dict(learning_rate=LR, gradient_accumulation_steps=2, model_max_length=48,
              max_visual_len=24, warmup_ratio=0.3, report_to="none", output_dir=str(tmp_path),
              **LORA)
    kw.update(over)
    return kw


def _pair(jparams, tmp_path, total=3, **over):
    """A JAX Trainer and the port's on the same params and the same adapters
    (JAX's init_lora tree, bridged)."""
    jcfg, tcfg = _cfgs()
    kw = _kw(tmp_path, **over)
    jt = jtr.Trainer(jcfg, jtr.TrainConfig(**kw), jax.tree_util.tree_map(jnp.copy, jparams),
                     total_steps=total, mesh=make_mesh(1, 1))
    tt = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), total_steps=total,
                     device="cpu", lora=to_torch(jt.lora))
    return jt, tt


def _run_pair(jt, tt, n, seed0=10):
    jcfg = _cfgs()[0]
    for i in range(n):
        batch = _batch(jcfg, seed=seed0 + i)
        ref = float(jt.train_step(batch))
        out = float(tt.train_step(batch))
        np.testing.assert_allclose(out, ref, atol=3e-4, rtol=3e-4)


def three_steps_match_jax(jparams, tmp_path, **over):
    """3 optimizer steps (6 micro-steps, accumulation 2) against the JAX
    Trainer: each micro-step's loss within 3e-4; the adapters and the extras
    held by _assert_params_close (trainable towers by the same rule); only
    the adapters and the extras move (the LM bitwise unchanged, its int8
    values too); export_merged against JAX's at 3e-4.  Returns the port's
    Trainer."""
    jt, tt = _pair(jparams, tmp_path, **over)
    before = {k: v.detach().clone() for k, v in _port_by_names(tt.params).items()}
    lora_before = {k: v.detach().clone() for k, v in _port_by_names(tt.lora).items()}
    _run_pair(jt, tt, 6)
    assert tt.tx.count == 3 and tt.step == 6
    _assert_params_close(tt.lora, jt.lora, lora_before, LR)
    # _assert_params_close requires frozen towers: trainable ones go under
    # another name.  Their k-projection biases have an exact gradient of 0
    # (softmax is invariant to a shift of a query's scores), so each
    # framework moves them by its own rounding noise: held to 2 lr like
    # every element, but kept out of the count of elements beyond 1e-2 lr
    towers = ("siglip", "dino") if over.get("unfreeze_mm_vision_tower") else ()

    def renamed(tree, numpy=False):
        out = {("trained_" + k if k in towers else k): v for k, v in tree.items()}
        for k in towers:
            layers = dict(out["trained_" + k]["layers"])
            kb = layers.pop("k_proj")["b"]
            got = np.asarray(kb) if numpy else kb.detach().numpy()
            bias[k].append(got)
            out["trained_" + k] = dict(out["trained_" + k], layers=dict(layers, k_proj={}))
        return out

    bias = {k: [] for k in towers}
    port_before = {k: v for k, v in before.items() if k[0] not in towers or k[2:] != ("k_proj", "b")}
    _assert_params_close(renamed(tt.params), renamed(jt.params, numpy=True),
                         {(("trained_" + k[0],) + k[1:] if k[0] in towers else k): v
                          for k, v in port_before.items()}, LR)
    for k, (got, want) in bias.items():
        np.testing.assert_allclose(got, want, atol=2 * LR, rtol=0, err_msg=k)
    for names, v in _port_by_names(tt.params).items():
        if names[0] == "lm":
            assert torch.equal(v, before[names]), names
    assert all(not torch.equal(v, lora_before[k]) for k, v in _port_by_names(tt.lora).items()
               if k[1] == "b")
    merged, ref = tt.export_merged(), jt.export_merged()
    for names, leaf in _port_by_names(merged).items():
        node = ref
        for n in names:
            node = node[int(n)] if isinstance(node, list) else node[n]
        assert leaf.dtype != torch.int8, names
        close(leaf, node)
    return tt


def test_lora_trainer_three_steps_match_jax(jparams, tmp_path):
    three_steps_match_jax(jparams, tmp_path)


def test_lora_respects_freeze_flags(jparams, tmp_path):
    """lora_enable with unfreeze_mm_compressor=False keeps the compressor
    frozen (JAX's test_lora_respects_freeze_flags): after 2 updates it is
    bitwise unchanged and out of the optimizer, while the SVA moves."""
    tcfg = _cfgs()[1]
    kw = _kw(tmp_path, gradient_accumulation_steps=1, unfreeze_mm_compressor=False)
    tt = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), total_steps=3, device="cpu")
    assert "compressor" not in tt._extra_keys and "sva" in tt._extra_keys
    before = {k: v.detach().clone() for k, v in _port_by_names(tt.params).items()}
    for i in range(2):  # the first update is inside the warmup (lr 0)
        assert np.isfinite(float(tt.train_step(_batch(_cfgs()[0], seed=30 + i))))
    moved = {k[0] for k, v in _port_by_names(tt.params).items() if not torch.equal(v, before[k])}
    assert "compressor" not in moved and "lm" not in moved and "sva" in moved


def test_quantize_frozen_requires_lora(jparams, tmp_path):
    tcfg = _cfgs()[1]
    with pytest.raises(ValueError, match="lora"):
        ttr.Trainer(tcfg, ttr.TrainConfig(output_dir=str(tmp_path), quantize_frozen="int8"),
                    to_torch(jparams), total_steps=2, device="cpu")
    with pytest.raises(ValueError, match="quantize_frozen"):
        ttr.Trainer(tcfg, ttr.TrainConfig(output_dir=str(tmp_path), quantize_frozen="int4",
                                          **LORA), to_torch(jparams), total_steps=2, device="cpu")


def test_lora_trainer_default_init_is_seeded(jparams, tmp_path):
    """Without a given tree the adapters come from tcfg.seed on the
    trainer's device: two trainers draw the same A; an explicit generator
    or seed draws another; a tree without lora_enable raises."""
    tcfg = _cfgs()[1]
    cfg = ttr.TrainConfig(**_kw(tmp_path))
    a = [ttr.Trainer(tcfg, cfg, to_torch(jparams), 2, device="cpu").lora["layers/q_proj/w"]["a"]
         for _ in range(2)]
    assert torch.equal(*a)
    b = ttr.Trainer(tcfg, cfg, to_torch(jparams), 2, device="cpu", lora_key=7).lora
    assert not torch.equal(b["layers/q_proj/w"]["a"], a[0])
    with pytest.raises(ValueError, match="lora_enable"):
        ttr.Trainer(tcfg, dataclasses.replace(cfg, lora_enable=False), to_torch(jparams), 2,
                    device="cpu", lora=b)
