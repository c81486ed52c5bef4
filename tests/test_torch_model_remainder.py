"""The model remainder of the port against the JAX package, on the CPU in
f32 with shared tdc_tiny weights (f32 compressor): the non-SVA projectors
(models/projector.py) on bridged params, get_frame_pos,
encode_frames(frame_indices=) and prepare_multimodal_inputs with
frame_pos on (its indices defaulting to each frame's position), all within
3e-4 (tests/test_golden.py's tolerance); TDCModel.generate token-identical
and TDCModel.loss within 3e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import builder as jbuilder
from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.models import projector as jproj
from tdc_video_tpu_torch import builder as tbuilder
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tmodel
from tdc_video_tpu_torch.constants import IGNORE_INDEX
from tdc_video_tpu_torch.models import projector as tproj
from torch_parity import close, t, to_torch


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


def _cfgs(frame_pos=False):
    jcfg = dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    if frame_pos:
        jcfg = dataclasses.replace(jcfg, compression=dataclasses.replace(jcfg.compression,
                                                                         frame_pos=True))
        tcfg = dataclasses.replace(tcfg, compression=dataclasses.replace(tcfg.compression,
                                                                         frame_pos=True))
    return jcfg, tcfg


@pytest.mark.parametrize("ptype", ["identity", "linear", "mlp2x_gelu", "mlp3x_gelu"])
def test_projector_forward_equals_jax(ptype):
    jp = jproj.init_projector(jax.random.PRNGKey(1), ptype, 24, 40)
    x = np.random.default_rng(0).normal(size=(3, 5, 24)).astype(np.float32)
    tp = {"type": jp["type"], "layers": [to_torch(p) for p in jp["layers"]]}
    close(tproj.projector_forward(tp, t(x)), jproj.projector_forward(jp, jnp.asarray(x)))
    mine = tproj.init_projector(ptype, 24, 40, torch.Generator().manual_seed(0), device="cpu")
    assert mine["type"] == jp["type"]
    assert [tuple(p["w"].shape) for p in mine["layers"]] == [p["w"].shape for p in jp["layers"]]
    assert [tuple(p["b"].shape) for p in mine["layers"]] == [p["b"].shape for p in jp["layers"]]
    out = tproj.projector_forward(mine, t(x))
    assert out.shape == ((3, 5, 24) if ptype == "identity" else (3, 5, 40))


def test_unknown_projector_raises():
    for fn in (lambda: tproj.init_projector("mlp_relu", 4, 4, torch.Generator(), device="cpu"),
               lambda: jproj.init_projector(jax.random.PRNGKey(0), "mlp_relu", 4, 4)):
        with pytest.raises(ValueError, match="Unknown projector type"):
            fn()


def test_get_frame_pos_equals_jax():
    jcfg, tcfg = _cfgs()
    idx = np.array([0, 1, 2, 7, 30, 999], np.int32)
    out = tmodel.get_frame_pos(tcfg, t(idx))
    close(out, jmodel.get_frame_pos(jcfg, jnp.asarray(idx)))
    assert out.shape == (6, tcfg.lm.hidden_size)


def _pixels(cfg, T, seed=0, B=None):
    rng = np.random.default_rng(seed)
    lead = (T,) if B is None else (B, T)
    s, d = cfg.siglip.image_size, cfg.dino.image_size
    return (rng.normal(size=lead + (s, s, 3)).astype(np.float32),
            rng.normal(size=lead + (d, d, 3)).astype(np.float32))


def test_encode_frames_frame_indices_equals_jax(params):
    jp, tp = params
    jcfg, tcfg = _cfgs(frame_pos=True)
    sig, dino = _pixels(jcfg, 5)
    idx = np.array([0, 2, 4, 9, 11], np.int32)
    ref = jmodel.encode_frames(jcfg, jp, jnp.asarray(sig), jnp.asarray(dino),
                               frame_indices=jnp.asarray(idx))
    out = tmodel.encode_frames(tcfg, tp, t(sig), t(dino), frame_indices=t(idx))
    close(out[0], ref[0])
    close(out[1], ref[1])
    plain = tmodel.encode_frames(tcfg, tp, t(sig), t(dino))
    close(out[0] - plain[0], tmodel.get_frame_pos(tcfg, t(idx))[:, None, :].expand_as(plain[0]))


def _request(cfg, B=2, T=4, L=24, seed=1):
    rng = np.random.default_rng(seed)
    sig, dino = _pixels(cfg, T, seed, B)
    return dict(
        input_ids=rng.integers(2, 500, (B, L)).astype(np.int32),
        image_pos=np.array([4, 6][:B], np.int32),
        siglip_px=sig, dino_px=dino,
        frame_mask=(np.arange(T)[None] < np.array([[T], [T - 1]][:B])),
        text_len=np.array([20, 24][:B], np.int32),
    )


def test_prepare_multimodal_inputs_frame_pos_equals_jax(params):
    jp, tp = params
    jcfg, tcfg = _cfgs(frame_pos=True)
    req = _request(jcfg)
    kw = dict(qformer_text_ids=None, qformer_text_mask=None, max_len=24 + 128,
              max_visual_len=128)
    ref = jax.jit(lambda p, r: jmodel.prepare_multimodal_inputs(jcfg, p, **r, **kw))(
        jp, {k: jnp.asarray(v) for k, v in req.items()})
    out = tmodel.prepare_multimodal_inputs(tcfg, tp, **{k: t(v) for k, v in req.items()}, **kw)
    close(out["embeds"], ref["embeds"])
    np.testing.assert_array_equal(out["attn_mask"].numpy(), np.asarray(ref["attn_mask"]))
    np.testing.assert_array_equal(out["seq_len"].numpy(), np.asarray(ref["seq_len"]))
    off = tmodel.prepare_multimodal_inputs(_cfgs()[1], tp, **{k: t(v) for k, v in req.items()},
                                           **kw)
    assert not torch.allclose(off["embeds"], out["embeds"])  # frame_pos moved the tokens


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.7, top_k=30)], ids=["greedy", "sampled"])
def test_tdc_model_generate_token_identical(params, sampling):
    from tdc_video_tpu_torch.serving import prng

    jp, tp = params
    jcfg, tcfg = _cfgs()
    req = _request(jcfg)
    kw = dict(max_new_tokens=6, max_len=24 + 128, max_visual_len=128, **sampling)
    ref = jax.jit(lambda p, r, key: jbuilder.TDCModel(jcfg, p).generate(**r, **kw, key=key))(
        jp, {k: jnp.asarray(v) for k, v in req.items()}, jax.random.PRNGKey(3))
    out = tbuilder.TDCModel(tcfg, tp).generate(**{k: t(v) for k, v in req.items()}, **kw,
                                               key=prng.PRNGKey(3))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("frame_pos", [False, True], ids=["plain", "frame_pos"])
def test_tdc_model_loss_equals_jax(params, frame_pos):
    jp, tp = params
    jcfg, tcfg = _cfgs(frame_pos)
    b = _request(jcfg, seed=2)
    labels = np.full(b["input_ids"].shape, IGNORE_INDEX, np.int32)
    labels[:, 10:] = b["input_ids"][:, 10:]
    b = dict(b, labels=labels, qformer_text_ids=np.ones((2, 6), np.int32),
             qformer_text_mask=np.ones((2, 6), bool))
    kw = dict(max_len=48, max_visual_len=24, loss_chunk=7)
    ref = jax.jit(lambda p, x: jbuilder.TDCModel(jcfg, p).loss(x, **kw))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    out = tbuilder.TDCModel(tcfg, tp).loss({k: t(v) for k, v in b.items()}, **kw)
    close(out, ref)
    assert torch.isfinite(out)
