"""The port's training checkpoints (Trainer.save / restore_if_available),
the saves of Trainer.fit, and its TensorBoard sink, on tdc_tiny on the CPU.

A checkpoint holds JAX's Orbax state, {"params", "step", "lora"}, in the
port's own layout (<output_dir>/checkpoints/<step>/state.safetensors): a
run saved, restored into a new Trainer and stepped once gives JAX's loss
for the same sequence within 3e-4; restored leaves equal the saved ones
bit for bit in their dtypes (f32, bf16, int8)."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import model as jm
from tdc_video_tpu.parallel.mesh import make_mesh
from tdc_video_tpu.train import trainer as jtr
from tdc_video_tpu_torch.train import trainer as ttr
from test_torch_train import _batch, _cfgs, jparams  # noqa: F401
from test_torch_train_lora import _kw
from torch_parity import to_torch


def _steps(trainer, n, seed0):
    return [float(trainer.train_step(_batch(_cfgs()[0], seed=seed0 + i))) for i in range(n)]


def test_save_restore_step_matches_jax(jparams, tmp_path):
    """LoRA, no accumulation: 2 steps, save; a new Trainer on other params
    restores (step 2, the saved params and adapters) and steps once; the
    JAX Trainer does the same with Orbax.  The resumed step's loss within
    3e-4 of JAX's; as in JAX, the optimizer starts afresh (its schedule at
    count 0)."""
    jcfg, tcfg = _cfgs()
    other = jm.init_tdc(jax.random.PRNGKey(9), jcfg)
    kw = _kw(tmp_path / "jax", gradient_accumulation_steps=1, warmup_ratio=0.0)
    ja = jtr.Trainer(jcfg, jtr.TrainConfig(**kw), jax.tree_util.tree_map(jnp.copy, jparams), 4,
                     mesh=make_mesh(1, 1))
    lora = to_torch(ja.lora)
    ref = _steps(ja, 2, 50)
    ja.save()
    jb = jtr.Trainer(jcfg, jtr.TrainConfig(**kw), other, 4, mesh=make_mesh(1, 1))
    assert jb.restore_if_available() and jb.step == 2
    ref += _steps(jb, 1, 52)

    kw = _kw(tmp_path / "port", gradient_accumulation_steps=1, warmup_ratio=0.0)
    ta = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), 4, device="cpu", lora=lora)
    out = _steps(ta, 2, 50)
    ta.save()
    assert os.path.exists(tmp_path / "port" / "checkpoints" / "2" / ttr.CKPT_FILE)
    tb = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(other), 4, device="cpu")
    assert tb.restore_if_available() and tb.step == 2 and tb.tx.count == 0
    for (name, x), y in zip(ta._state().items(), tb._state().values()):
        assert torch.equal(x, y), name
    out += _steps(tb, 1, 52)
    np.testing.assert_allclose(out, ref, atol=3e-4, rtol=3e-4)


def test_restore_is_bitwise_in_each_dtype(jparams, tmp_path):
    """QLoRA over a bf16 LM: the checkpoint holds f32 (adapters, extras),
    bf16 (the embedding) and int8 (the base) leaves; a new Trainer restores
    each bit for bit in its dtype, and raises on a checkpoint of another
    layout."""
    tcfg = _cfgs()[1]
    kw = _kw(tmp_path, gradient_accumulation_steps=1, quantize_frozen="int8", warmup_ratio=0.0)

    def params(seed):
        p = to_torch(jm.init_tdc(jax.random.PRNGKey(seed), _cfgs()[0]))
        p["lm"] = {k: {n: t.to(torch.bfloat16) for n, t in v.items()} if isinstance(v, dict) and
                   k == "embed" else v for k, v in p["lm"].items()}
        return p

    a = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), params(0), 3, device="cpu")
    _steps(a, 2, 60)
    a.save()
    b = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), params(9), 3, device="cpu", lora_key=5)
    assert b.restore_if_available() and b.step == 2
    dtypes = set()
    for (name, x), y in zip(a._state().items(), b._state().values()):
        assert x.dtype == y.dtype and torch.equal(x, y), name
        dtypes.add(x.dtype)
    assert {torch.float32, torch.bfloat16, torch.int8} <= dtypes
    plain = ttr.Trainer(tcfg, ttr.TrainConfig(**dict(kw, quantize_frozen=None)), params(0), 3,
                        device="cpu")
    with pytest.raises(ValueError, match="leaves differ|is torch"):
        plain.restore_if_available()


def test_async_save_restores(jparams, tmp_path):
    """save(wait=False) copies to the host before returning: the next step
    changes the params while the write runs, and a restore sees the state
    of the save; a later blocking save makes the newer step durable."""
    tcfg = _cfgs()[1]
    kw = _kw(tmp_path, gradient_accumulation_steps=1, warmup_ratio=0.0, save_total_limit=3)
    a = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), 4, device="cpu")
    _steps(a, 1, 70)
    a.save(wait=False)
    snap = {k: v.detach().clone() for k, v in a._state().items()}
    _steps(a, 1, 71)
    b = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), 4, device="cpu")
    a._join_write()
    assert b.restore_if_available() and b.step == 1
    for name, y in b._state().items():
        assert torch.equal(snap[name], y), name
    a.save()
    assert b.restore_if_available() and b.step == 2
    assert not glob.glob(str(tmp_path / "checkpoints" / "*.tmp"))


def test_save_total_limit_keeps_the_newest(jparams, tmp_path):
    """save_total_limit=2 keeps the two newest steps; a step at or below the
    newest saved one is not saved again (Orbax's rule)."""
    tcfg = _cfgs()[1]
    kw = _kw(tmp_path, gradient_accumulation_steps=1, save_total_limit=2)
    a = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), 4, device="cpu")
    for i in range(3):
        _steps(a, 1, 80 + i)
        a.save(wait=i != 2)
    a.save()
    assert a._saved_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2", "3"]


@pytest.mark.parametrize("save_steps,expected", [(1, [1, 2, 3]), (2, [2, 3])])
def test_fit_saves_every_save_steps_and_at_the_end(jparams, tmp_path, save_steps, expected):
    """fit saves every save_steps without waiting and once more at the end
    (JAX's fit; it raised before the port had save): with max_steps=3 the
    checkpoints are each multiple of save_steps and the last step; the
    metrics file has a finite loss a step."""
    tcfg = _cfgs()[1]
    kw = _kw(tmp_path, gradient_accumulation_steps=1, save_steps=save_steps, save_total_limit=5,
             max_steps=3, report_to="jsonl")
    a = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), 3, device="cpu")
    a.fit(_batch(_cfgs()[0], seed=90 + i) for i in range(5))
    assert a.step == 3 and a._saved_steps() == expected
    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2, 3] and all(np.isfinite(x["loss"]) for x in lines)
    a.close()


def test_tensorboard_event_file(jparams, tmp_path):
    """report_to="tensorboard" writes an event file under
    <output_dir>/tensorboard_logs (as JAX's SummaryWriter sink)."""
    pytest.importorskip("torch.utils.tensorboard")
    tcfg = _cfgs()[1]
    kw = _kw(tmp_path, gradient_accumulation_steps=1, report_to="tensorboard")
    a = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), 2, device="cpu")
    a.log({"loss": float(a.train_step(_batch(_cfgs()[0], seed=95)))})
    a.close()
    events = glob.glob(str(tmp_path / "tensorboard_logs" / "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 0
