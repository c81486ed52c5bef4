"""Port end to end on tdc_tiny against the JAX package, on the CPU, with
shared weights: generate_encoded and TDCPredictor.answer must give the same
greedy tokens.  Both run with compress_dtype f32, so that token identity is
a fair demand; one comparison at the preset's bf16 compress_dtype holds the
prefill logits within a stated tolerance instead."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.eval.runner import HFTokenizerAdapter
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.serving.generate import generate_encoded as jax_generate_encoded
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.serving.generate import generate_encoded, prefill_encoded
from torch_parity import StubTokenizer, close, t, to_torch


class JaxStubTokenizer(HFTokenizerAdapter):
    """The stub tokenizer behind the JAX package's adapter protocol."""

    def __init__(self):
        self.tok = None
        self._stub = StubTokenizer()

    def encode(self, text):
        return self._stub.encode(text)

    def decode(self, ids):
        return self._stub.decode(ids)


def _cfgs(compress_f32: bool):
    jcfg, tcfg = jc.tdc_tiny(), tc.tdc_tiny()
    if compress_f32:
        jcfg = dataclasses.replace(jcfg, compress_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compress_dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


def _encoded_request(seed):
    """Random pre-encoded frames and prompt, shaped as TDCPredictor builds them."""
    rng = np.random.default_rng(seed)
    T, P, H = 8, 20, 64
    return dict(
        input_ids=rng.integers(2, 500, (1, 32)).astype(np.int32),
        image_pos=np.array([5], np.int32),
        frame_feats=rng.normal(size=(1, T, P, H)).astype(np.float32),
        dino_feats=rng.normal(size=(1, T, 16, 48)).astype(np.float32),
        frame_mask=(np.arange(T) < 6)[None],
        qformer_text_ids=rng.integers(0, 128, (1, 16)).astype(np.int32),
        qformer_text_mask=(np.arange(16) < 10)[None],
        text_len=np.array([27], np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_encoded_token_identical(params, seed):
    jcfg, tcfg = _cfgs(compress_f32=True)
    jp, tp = params
    req = _encoded_request(seed)
    kw = dict(max_new_tokens=8, max_len=32 + 256, max_visual_len=256)
    ref = jax_generate_encoded(jcfg, jp, **{k: jnp.asarray(v) for k, v in req.items()}, **kw,
                               attn_impl="flash")
    out = generate_encoded(tcfg, tp, **{k: t(v) for k, v in req.items()}, **kw, attn_impl="flash")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_bf16_compression_prefill_logits(params):
    """At the preset's bf16 compress_dtype the Q-Former rounds differently in
    the two frameworks; last-token prefill logits agree within 2e-2 (logits
    here are O(1); bf16 keeps ~3 significant digits through 4 Q-Former
    layers and a unit-norm projection)."""
    jcfg, tcfg = _cfgs(compress_f32=False)
    jp, tp = params
    req = _encoded_request(2)
    max_len, max_vis = 32 + 256, 256
    mm = jmodel.prepare_multimodal_from_features(
        jcfg, jp, *(jnp.asarray(req[k]) for k in ("input_ids", "image_pos", "frame_feats",
                                                   "dino_feats", "frame_mask", "qformer_text_ids",
                                                   "qformer_text_mask")),
        text_len=jnp.asarray(req["text_len"]), max_len=max_len, max_visual_len=max_vis)
    cache = jlm.init_kv_cache(jcfg.lm, 1, max_len + 8, dtype=jnp.float32)
    ref, _ = jlm.prefill(jcfg.lm, jp["lm"], mm["embeds"], mm["attn_mask"], cache,
                         attn_impl="flash", dtype=jnp.float32)
    out, _ = prefill_encoded(tcfg, tp, **{k: t(v) for k, v in req.items()}, max_new_tokens=8,
                             max_len=max_len, max_visual_len=max_vis, attn_impl="flash")
    close(out, ref, atol=2e-2, rtol=0)


def _answers_token_identical(params, device_preprocess):
    jcfg, tcfg = _cfgs(compress_f32=True)
    jp, tp = params
    frames = np.random.default_rng(3).integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    frames[3:, :, :32] = 255 - frames[3:, :, :32]  # a visible change mid-clip
    jpred = JaxPredictor(jcfg, jp, JaxStubTokenizer(), max_new_tokens=8, text_bucket=128,
                         device_preprocess=device_preprocess)
    tpred = TorchPredictor(tcfg, tp, StubTokenizer(), max_new_tokens=8, text_bucket=128,
                           device_preprocess=device_preprocess, device="cpu")
    for question in ("What happens?", "Which color is on the left?"):
        ref = jpred.answer(frames, question)
        out = tpred.answer(frames, question)
        assert out == ref
        assert out == StubTokenizer().decode(tpred.stats.last_ids)


def test_predictor_answer_token_identical(params):
    """TDCPredictor.answer in both packages: uint8 frames through the
    device-side preprocessing, towers, SVA, compression, prefill, decode."""
    _answers_token_identical(params, device_preprocess=True)


def test_predictor_answer_token_identical_host_path(params):
    """The same on the default host path (PIL's bicubic chain in JAX, its
    numpy copy in the port)."""
    _answers_token_identical(params, device_preprocess=False)


@pytest.mark.parametrize("eos_at", [0, 3, 8])
def test_decode_loop_checks_done_every_k_steps(params, eos_at, monkeypatch):
    """decode_loop reads its stop condition back to the host once every
    DONE_CHECK_EVERY steps: the tokens are JAX's (pad after the EOS), the
    steps run exceed the per-token loop's count by less than
    DONE_CHECK_EVERY, and the host reads `done` no more often."""
    from tdc_video_tpu.serving.generate import generate_text_only
    from tdc_video_tpu_torch.models import lm as tlm
    from tdc_video_tpu_torch.serving import generate as tgen

    jp, tp = params
    k = tgen.DONE_CHECK_EVERY
    ids = np.random.default_rng(9).integers(2, 100, (1, 10)).astype(np.int32)
    mask = np.ones(ids.shape, bool)

    def run(cfg, new=12):
        emb = tlm.embed_tokens(cfg.lm, tp["lm"], t(ids), cfg.dtype)
        cache = tlm.init_kv_cache(cfg.lm, 1, 10 + new, dtype=cfg.dtype, device="cpu")
        logits, cache = tlm.prefill(cfg.lm, tp["lm"], emb, t(mask), cache, dtype=cfg.dtype)
        return tgen.decode_loop(cfg, tp, cache, logits.argmax(-1).to(torch.int32), new)

    probe, _ = run(tc.tdc_tiny())
    eos = int(probe[0, eos_at])
    true_steps = int(np.where(probe[0].numpy() == eos)[0][0])  # the per-token loop's count
    tcfg = dataclasses.replace(tc.tdc_tiny(),
                               lm=dataclasses.replace(tc.LM_TINY, eos_token_ids=(eos,)))
    jcfg = dataclasses.replace(jc.tdc_tiny(),
                               lm=dataclasses.replace(jc.LM_TINY, eos_token_ids=(eos,)))
    reads = []
    real_bool = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda x: reads.append(1) or real_bool(x))
    out, steps = run(tcfg)
    monkeypatch.undo()
    ref = generate_text_only(jcfg, jp, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=12)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert true_steps <= steps < true_steps + k
    assert len(reads) <= steps // k + 1


def test_prepare_multimodal_multi_image_matches_jax():
    """Two <image> slots per sample (one row with a single image) through the
    uncompressed stage-1 image path, against JAX at 3e-4 in f32
    (tests/test_model_e2e.py::TestMultiImage): embeddings, masks, labels
    and lengths."""
    from tdc_video_tpu_torch import model as tmodel

    jcfg, tcfg = _cfgs(compress_f32=True)
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jcfg)
    B, M, L = 2, 2, 24
    rng = np.random.default_rng(5)
    s, d = jcfg.siglip.image_size, jcfg.dino.image_size
    ids = rng.integers(2, 100, (B, L)).astype(np.int32)
    pos = np.asarray([[3, 9], [5, -1]], np.int32)
    sig = rng.normal(0, 1, (B, M, s, s, 3)).astype(np.float32)
    dino = rng.normal(0, 1, (B, M, d, d, 3)).astype(np.float32)
    labels = rng.integers(2, 100, (B, L)).astype(np.int32)
    ref = jmodel.prepare_multimodal_multi_image(
        jcfg, jp, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(sig), jnp.asarray(dino),
        labels=jnp.asarray(labels), max_len=128)
    out = tmodel.prepare_multimodal_multi_image(tcfg, to_torch(jp), t(ids), t(pos), t(sig), t(dino),
                                                labels=t(labels), max_len=128)
    close(out["embeds"], ref["embeds"])
    for k in ("attn_mask", "labels", "seq_len"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    P = tmodel.frame_token_len(tcfg)
    assert int(out["seq_len"][0]) == L + 2 * P - 2 and int(out["seq_len"][1]) == L + P - 1
