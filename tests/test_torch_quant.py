"""int8 quantization of the port (models/quant.py, the int8 paths of
models/layers.py, lm.py and vit.py, load_pretrained_model(quantize=)) against the JAX
package, on the CPU in f32 with shared weights.

JAX quantizes, the numpy bridge carries the quantized tree across, and both
packages run the same inputs.  Tolerances: w_q bitwise (both round half to
even), w_scale 1e-7 relative; int8_qact / int8_dot / int8_matmul 1e-5; LM
logits (int8 weights, act-quant prefill, int8 KV cache over prefill and 10
decode steps) and the int8 towers 3e-4 (golden suite); answers from a
quantized checkpoint token-identical.  The port also keeps JAX's drift
bounds against float (tests/test_quant.py): logits 0.05 (weight-only and
int8 KV), 0.08 (act-quant), greedy agreement >= 0.8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import builder as jbuilder
from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.models import layers as jlayers
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.models import quant as jquant
from tdc_video_tpu.models import vit as jvit
from tdc_video_tpu_torch import builder as tbuilder
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.models import layers as tlayers
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.models import quant as tquant
from tdc_video_tpu_torch.models import vit as tvit
from test_builder import write_checkpoint
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer, close, t, to_torch


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


def assert_quantized_equal(port, ref, path="params"):
    """w_q bitwise (dtype int8), w_scale within 1e-7 relative, calibrated
    act_scale tables (amaxes of a float forward) at 3e-4, every other leaf
    equal."""
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref), path
        for k in ref:
            assert_quantized_equal(port[k], ref[k], f"{path}/{k}")
        return
    if isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_quantized_equal(a, b, f"{path}[{i}]")
        return
    if ref is None:
        assert port is None, path
        return
    a, b = _np(port), np.asarray(ref)
    assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
    if path.endswith("w_scale"):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=0, err_msg=path)
    elif "/act_scale/" in path:
        close(a, b)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.fixture(scope="module")
def lm_params():
    jp = jlm.init_lm(jax.random.PRNGKey(0), jc.LM_TINY)
    return jp, jquant.quantize_lm_int8(jp)


def test_quantize_lm_matches_jax(lm_params):
    """Quantizing in the port gives JAX's tree: stacked [L, in, out] leaves,
    the untied head, the float embedding."""
    jp, jq = lm_params
    out = tquant.quantize_lm_int8(to_torch(jp))
    assert out["layers"]["q_proj"]["w_q"].dtype == torch.int8
    assert "embedding" in out["embed"] and "w_q" in out["lm_head"]
    assert_quantized_equal(out, jax.tree_util.tree_map(np.asarray, jq))
    skip = tquant.quantize_lm_int8(to_torch(jp), include_head=False)
    assert_quantized_equal(skip, jax.tree_util.tree_map(
        np.asarray, jquant.quantize_lm_int8(jp, include_head=False)))


def test_quantize_linear_roundtrip_and_dequantize():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.05, (64, 32)).astype(np.float32)
    jq = jquant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.ones(32)})
    q = tquant.quantize_linear_int8({"w": t(w), "b": torch.ones(32)})
    assert_quantized_equal(q, jax.tree_util.tree_map(np.asarray, jq))
    back = tquant.dequantize_linear(q)
    close(back["w"], jquant.dequantize_linear(jq)["w"], atol=0, rtol=0)
    # per-channel symmetric int8: error <= scale / 2 per channel
    assert np.abs(back["w"].numpy() - w).max() <= float(q["w_scale"].max()) / 2 + 1e-7
    tree = {"a": q, "s": {"act_scale": torch.ones(3)}}
    deq = tquant.dequantize_tree_int8(tree)
    assert set(deq["a"]) == {"w", "b"} and deq["s"]["act_scale"] is tree["s"]["act_scale"]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_ops_match_jax(static):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 7, 48)).astype(np.float32)
    w = rng.normal(0, 0.05, (48, 40)).astype(np.float32)
    scale = np.float32(0.03) if static else None
    jq = jquant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(w[0])})
    tq = to_torch(jq)
    jx_q, jx_s = jlayers.int8_qact(jnp.asarray(x), None if scale is None else jnp.asarray(scale))
    tx_q, tx_s = tlayers.int8_qact(t(x), None if scale is None else torch.tensor(scale))
    np.testing.assert_array_equal(tx_q.numpy(), np.asarray(jx_q))
    close(tx_s, jx_s, atol=1e-5, rtol=1e-5)
    close(tlayers.int8_dot(tx_q, tx_s, tq, torch.float32),
          jlayers.int8_dot(jx_q, jx_s, jq, jnp.float32), atol=1e-5, rtol=1e-5)
    close(tlayers.int8_matmul(t(x), tq["w_q"], tq["w_scale"]),
          jlayers.int8_matmul(jnp.asarray(x), jq["w_q"], jq["w_scale"]), atol=1e-5, rtol=1e-5)
    for act_quant in (False, True):
        close(tlayers.linear(tq, t(x), act_quant=act_quant),
              jlayers.linear(jq, jnp.asarray(x), act_quant=act_quant), atol=1e-5, rtol=1e-5)


def test_int_mm_pads_to_exact_product():
    """The s8 product's padding (rows to 17, K and N to multiples of 8, as
    CUDA's _int_mm needs) is exact: the CPU product of the padded operands
    equals the unpadded one."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-127, 128, (5, 588)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (588, 36)).astype(np.int8))
    ref = x.double() @ w.double()
    np.testing.assert_array_equal(tlayers._int_mm(x, w).double().numpy(), ref.numpy())


def test_lm_forward_int8_matches_jax_and_drift(lm_params):
    jp, jq = lm_params
    tq = to_torch(jq)
    ids = np.random.default_rng(3).integers(2, jc.LM_TINY.vocab_size, (2, 16)).astype(np.int32)
    for act_quant, bound in ((False, 0.05), (True, 0.08)):
        ref = jlm.lm_forward(jc.LM_TINY, jq, input_ids=jnp.asarray(ids), dtype=jnp.float32,
                             act_quant=act_quant)
        out = tlm.lm_forward(tc.LM_TINY, tq, input_ids=t(ids), dtype=torch.float32,
                             act_quant=act_quant)
        close(out, ref)
        flt = tlm.lm_forward(tc.LM_TINY, to_torch(jp), input_ids=t(ids), dtype=torch.float32)
        assert _rel(out, flt) < bound
        agree = (_np(out).argmax(-1) == _np(flt).argmax(-1)).mean()
        assert agree > 0.85, agree


@pytest.mark.parametrize("mode", ["int8_weights", "act_quant", "int8_kv"])
def test_prefill_and_decode_match_jax(lm_params, mode):
    """Prefill and 10 greedy-fed decode steps through each quantized path:
    logits within 3e-4 of JAX's same path."""
    jp, jq = lm_params
    weights = jp if mode == "int8_kv" else jq
    tw = to_torch(weights)
    kv = "int8" if mode == "int8_kv" else None
    act = mode == "act_quant"
    rng = np.random.default_rng(4)
    B, T, cap = 2, 12, 24
    emb = rng.normal(size=(B, T, jc.LM_TINY.hidden_size)).astype(np.float32)
    am = np.arange(T)[None] < np.array([[12], [9]])
    jcache = jlm.init_kv_cache(jc.LM_TINY, B, cap, dtype=jnp.float32, quant=kv)
    jlog, jcache = jlm.prefill(jc.LM_TINY, weights, jnp.asarray(emb), jnp.asarray(am), jcache,
                               dtype=jnp.float32, act_quant=act)
    tcache = tlm.init_kv_cache(tc.LM_TINY, B, cap, dtype=torch.float32, device="cpu", quant=kv)
    tlog, tcache = tlm.prefill(tc.LM_TINY, tw, t(emb), t(am), tcache, dtype=torch.float32,
                               act_quant=act)
    close(tlog, jlog)
    if kv:
        assert tcache["k"].dtype == torch.int8 and tcache["k_scale"].dtype == torch.float32
        np.testing.assert_array_equal(tcache["k"].numpy(), np.asarray(jcache["k"]))
    for _ in range(10):
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
        jlog, jcache = jlm.decode_step(jc.LM_TINY, weights,
                                       jlm.embed_tokens(jc.LM_TINY, weights, jnp.asarray(tok),
                                                        jnp.float32), jcache, dtype=jnp.float32)
        tlog, tcache = tlm.decode_step(tc.LM_TINY, tw,
                                       tlm.embed_tokens(tc.LM_TINY, tw, t(tok), torch.float32),
                                       tcache, dtype=torch.float32)
        close(tlog, jlog)


def test_int8_kv_drift_bounded(lm_params):
    """JAX's drift bounds for the int8 cache: prefill logits within 0.05 of
    the f32 cache's, and greedy streams agreeing on >= 0.8 of 10 tokens."""
    jp, _ = lm_params
    tp = to_torch(jp)
    rng = np.random.default_rng(6)
    ids = t(rng.integers(2, tc.LM_TINY.vocab_size, (2, 16)).astype(np.int32))
    emb = tlm.embed_tokens(tc.LM_TINY, tp, ids, torch.float32)
    am = torch.ones(ids.shape, dtype=torch.bool)
    streams = []
    for kv in (None, "int8"):
        cache = tlm.init_kv_cache(tc.LM_TINY, 2, 26, dtype=torch.float32, device="cpu", quant=kv)
        logits, cache = tlm.prefill(tc.LM_TINY, tp, emb, am, cache, dtype=torch.float32)
        toks = [logits.argmax(-1)]
        for _ in range(9):
            e = tlm.embed_tokens(tc.LM_TINY, tp, toks[-1][:, None], torch.float32)
            lg, cache = tlm.decode_step(tc.LM_TINY, tp, e, cache, dtype=torch.float32)
            toks.append(lg.argmax(-1))
        streams.append((logits, torch.stack(toks, 1)))
    assert _rel(streams[1][0], streams[0][0]) < 0.05
    assert (streams[1][1] == streams[0][1]).float().mean() >= 0.8


@pytest.mark.parametrize("tower", ["siglip", "dino"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
def test_int8_towers_match_jax(tower, static):
    """The int8 tower (dynamic per-token or calibrated static scales) and the
    calibration statistics against JAX at 3e-4; drift against the float
    tower within JAX's bounds (rel 0.05 dynamic, 0.06 static)."""
    jcfg, tcfg = getattr(jc.tdc_tiny(), tower), getattr(tc.tdc_tiny(), tower)
    jp = jvit.init_vit(jax.random.PRNGKey(1), jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    px = rng.normal(0, 1, (2, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    scales = None
    if static:
        calib = rng.normal(0, 1, (2, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
        scales = jquant.calibrate_vit_act_scales(jcfg, jp, jnp.asarray(calib), dtype=jnp.float32)
        tscales = tquant.calibrate_vit_act_scales(tcfg, to_torch(jp), t(calib), dtype=torch.float32)
        assert sorted(tscales) == ["attn", "down", "mlp", "qkv"]
        for k in scales:
            assert tscales[k].shape == (jcfg.num_layers,)
            close(tscales[k], scales[k])
    jq = jquant.quantize_vit_int8(jp, act_scales=scales)
    tq = tquant.quantize_vit_int8(to_torch(jp), act_scales=None if scales is None else
                                  {k: t(v) for k, v in scales.items()})
    assert_quantized_equal(tq, jax.tree_util.tree_map(np.asarray, jq))
    ref = jvit.vit_forward(jcfg, jq, jnp.asarray(px))
    out = tvit.vit_forward(tcfg, tq, t(px))
    close(out, ref)
    flt = tvit.vit_forward(tcfg, to_torch(jp), t(px)).numpy()
    o = out.numpy()
    rel = np.linalg.norm(o - flt) / np.linalg.norm(flt)
    assert rel < (0.06 if static else 0.05), rel


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("qckpt") / "tdc-tiny")
    write_checkpoint(path, jc.tdc_tiny(), audio=False)
    return path


def _calib_pixels(cfg):
    rng = np.random.default_rng(11)
    return tuple(rng.normal(0, 1, (2, c.image_size, c.image_size, 3))
                 for c in (cfg.siglip, cfg.dino))


@pytest.mark.parametrize("quantize,calibrated,kv_quant",
                         [("int8", False, None), ("int8-all", False, None),
                          ("int8-all", True, None), ("int8", False, "int8")],
                         ids=["int8", "int8-all", "int8-all-calibrated", "int8-kv-int8"])
def test_answer_from_quantized_checkpoint_token_identical(ckpt, quantize, calibrated, kv_quant):
    """load_pretrained_model(quantize=...) in both packages: the same int8
    tree, and answer tokens identical (act-quant prefill with int8-all, as
    the demo runs it); f32 compute and compressor."""
    calib = _calib_pixels(jc.tdc_tiny()) if calibrated else None
    _, jm, _, _ = jbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=jnp.float32,
                                                 quantize=quantize, calib_pixels=calib)
    _, tm, _, _ = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=torch.float32,
                                                 device="cpu", quantize=quantize,
                                                 calib_pixels=calib)
    assert tm.params["lm"]["layers"]["q_proj"]["w_q"].dtype == torch.int8
    assert ("w_q" in tm.params["siglip"]["layers"]["q_proj"]) == (quantize == "int8-all")
    assert ("act_scale" in tm.params["dino"]["layers"]) == calibrated
    assert "w" in tm.params["sva"]["mm_projector"]["fc1"]  # the connector stays float
    assert_quantized_equal(tm.params, jax.tree_util.tree_map(np.asarray, jm.params))
    act = quantize == "int8-all"
    jcfg = dataclasses.replace(jm.cfg, compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.cfg, compress_dtype=torch.float32)
    jpred = JaxPredictor(jcfg, jm.params, JaxStubTokenizer(), max_new_tokens=8, text_bucket=128,
                         act_quant=act, kv_quant=kv_quant)
    tpred = TorchPredictor(tcfg, tm.params, StubTokenizer(), max_new_tokens=8, text_bucket=128,
                           device="cpu", act_quant=act, kv_quant=kv_quant)
    frames = np.random.default_rng(3).integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    frames[3:, :, :32] = 255 - frames[3:, :, :32]
    for question in ("What happens?", "Which color is on the left?"):
        assert tpred.answer(frames, question, video_uid="clip") == \
            jpred.answer(frames, question, video_uid="clip")


def test_unknown_quantize_mode_raises(ckpt):
    with pytest.raises(ValueError, match="int4"):
        tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, quantize="int4", device="cpu")


def test_lora_linear_raises():
    """A LoRA linear over an int8 weight computes the scaled int8 product
    plus (x A) B; merging the adapter into the int8 weight raises
    (train/lora.apply_lora: dequantize first)."""
    from tdc_video_tpu_torch.train import lora as tlora

    q = tquant.quantize_linear_int8({"w": torch.ones(4, 4)})
    p = dict(q, lora_a=torch.ones(4, 2), lora_b=torch.ones(2, 4))
    x = torch.ones(1, 4)
    assert torch.equal(tlayers.linear(p, x), tlayers.linear(q, x) + 8.0)
    with pytest.raises(ValueError, match="int8"):
        tlora.apply_lora({"layer": {"q_proj": q}},
                         {"layer/q_proj/w": {"a": torch.ones(4, 2), "b": torch.ones(2, 4)}}, 2, 2)


def test_encode_frames_int8_towers_match_jax():
    """encode_frames with both towers int8 (the serving configuration of
    --quantize int8-all) against JAX at 3e-4, and within JAX's 0.08 drift
    bound of the float towers."""
    from tdc_video_tpu_torch import model as tmodel

    jcfg = dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jcfg)
    jq = dict(jp, siglip=jquant.quantize_vit_int8(jp["siglip"]),
              dino=jquant.quantize_vit_int8(jp["dino"]))
    rng = np.random.default_rng(4)
    sig = rng.normal(0, 1, (3, jcfg.siglip.image_size, jcfg.siglip.image_size, 3)).astype(np.float32)
    dino = rng.normal(0, 1, (3, jcfg.dino.image_size, jcfg.dino.image_size, 3)).astype(np.float32)
    ref, _ = jmodel.encode_frames(jcfg, jq, jnp.asarray(sig), jnp.asarray(dino))
    out, _ = tmodel.encode_frames(tcfg, to_torch(jq), t(sig), t(dino))
    close(out, ref)
    flt, _ = tmodel.encode_frames(tcfg, to_torch(jp), t(sig), t(dino))
    o, f = out.numpy(), flt.numpy()
    assert np.linalg.norm(o - f) / np.linalg.norm(f) < 0.08
