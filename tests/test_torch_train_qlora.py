"""Port parity of the QLoRA Trainer (train/trainer.py with lora_enable and
quantize_frozen="int8": the frozen base stored as weight-only int8 under
the adapters) on tdc_tiny in f32, on the CPU, against the JAX Trainer.

Tolerances as test_torch_train_lora.py.  The parity run over 3 optimizer
steps keeps the towers trainable (so float): fully frozen towers are
stored int8 and run with per-token int8 activations, whose rounding the
two frameworks' f32 sums can flip (measured on these batches: encode_frames
differs by up to 1.7e-2 on 2 of 6), a jump that is no fault of either.  The
default layout (frozen towers int8) is held bitwise against JAX's trainer,
and its export against dequantize + merge."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tdc_video_tpu.parallel.mesh import make_mesh
from tdc_video_tpu.train import trainer as jtr
from tdc_video_tpu_torch.models import quant as tquant
from tdc_video_tpu_torch.train import lora as tlora
from tdc_video_tpu_torch.train import trainer as ttr
from test_torch_quant import assert_quantized_equal
from test_torch_train import _batch, _cfgs, _port_by_names, jparams  # noqa: F401
from test_torch_train_lora import _kw, three_steps_match_jax
from torch_parity import to_torch


def test_qlora_trainer_three_steps_match_jax(jparams, tmp_path):
    """The LM int8 under the adapters, the towers trainable (float): as
    test_torch_train_lora's LoRA run, export_merged dequantized and merged."""
    tt = three_steps_match_jax(jparams, tmp_path, quantize_frozen="int8",
                               unfreeze_mm_vision_tower=True)
    assert tt.params["lm"]["layers"]["q_proj"]["w_q"].dtype == torch.int8
    assert "w" in tt.params["siglip"]["layers"]["q_proj"]


def test_qlora_layout_matches_jax_and_exports_float(jparams, tmp_path):
    """The default stage flags under quantize_frozen="int8": the LM (head
    included) and both fully frozen towers int8, bitwise as JAX's trainer
    stores them, the embedding float; two updates leave the int8 base
    unchanged and move B; export_merged has no int8 leaf and equals
    dequantize + merge recomputed here."""
    jcfg, tcfg = _cfgs()
    kw = _kw(tmp_path, gradient_accumulation_steps=1, quantize_frozen="int8", warmup_ratio=0.0)
    jt = jtr.Trainer(jcfg, jtr.TrainConfig(**kw), jax.tree_util.tree_map(jnp.copy, jparams),
                     total_steps=4, mesh=make_mesh(1, 1))
    tt = ttr.Trainer(tcfg, ttr.TrainConfig(**kw), to_torch(jparams), total_steps=4,
                     device="cpu", lora=to_torch(jt.lora))
    for mod in ("lm", "siglip", "dino"):
        assert_quantized_equal(tt.params[mod], jax.tree_util.tree_map(np.asarray, jt.params[mod]))
    assert tt.params["lm"]["lm_head"]["w_q"].dtype == torch.int8
    assert tt.params["lm"]["embed"]["embedding"].dtype == torch.float32
    wq0 = tt.params["lm"]["layers"]["q_proj"]["w_q"].clone()
    for i in range(2):
        assert np.isfinite(float(tt.train_step(_batch(jcfg, seed=40 + i))))
    assert torch.equal(wq0, tt.params["lm"]["layers"]["q_proj"]["w_q"])
    assert tt.lora["layers/q_proj/w"]["b"].abs().max() > 0
    merged = tt.export_merged()
    assert all(v.dtype != torch.int8 for v in _port_by_names(merged).values())
    deq = tquant.dequantize_tree_int8(tt.params["lm"], dtype=tcfg.param_dtype)
    want = tlora.apply_lora(deq, tt.lora, 8, 4)
    for names, v in _port_by_names(want).items():
        node = merged["lm"]
        for n in names:
            node = node[n]
        assert torch.equal(node, v), names
    assert not torch.equal(merged["lm"]["layers"]["q_proj"]["w"], deq["layers"]["q_proj"]["w"])


