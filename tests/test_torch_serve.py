"""Multi-question serving of the port against the JAX package, on the CPU
with shared tdc_tiny weights in f32 (f32 compressor, as the other
token-identity tests): TDCPredictor.answer_many with prefix sharing engaged
and off, generate (from pixels) and generate_text_only greedy and sampled,
and cli/serve.main in its plain, --chat and --stream modes on a checkpoint
written by convert/to_hf and a clip from media.io.encode_test_video (the
printed answers, streams included, must equal JAX's; the CLI cases skip
where pkg-config finds no FFmpeg).  Every comparison is token-identical
(tolerance 0).
"""

import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.serving import generate as jgen
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.serving import generate as tgen
from tdc_video_tpu_torch.serving import prng
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer, t, to_torch


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


def _cfgs():
    return (dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32),
            dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32))


QUESTIONS = ["What happens?", "Which color is on the left?", "Why?"]


@pytest.fixture(scope="module")
def predictors(params):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    jpred = JaxPredictor(jcfg, jp, JaxStubTokenizer(), max_new_tokens=6, text_bucket=128)
    tpred = TorchPredictor(tcfg, tp, StubTokenizer(), max_new_tokens=6, text_bucket=128,
                           device="cpu")
    frames = np.random.default_rng(3).integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    frames[3:, :, :32] = 255 - frames[3:, :, :32]
    return jpred, tpred, frames


@pytest.mark.parametrize("share,sampling", [
    (True, {}), (False, {}), (True, dict(temperature=0.8, top_k=20, seed=4)),
], ids=["shared_prefix", "no_sharing", "shared_sampled"])
def test_answer_many_equals_jax(predictors, share, sampling):
    """answer_many over one video: JAX's strings; with sharing the prefix
    (template head and video tokens, the Q-Former unconditioned) prefills
    once; each greedy answer equals answer() on its question alone."""
    jpred, tpred, frames = predictors
    kw = dict(video_uid="clip", num_slots=2, prefix_share_threshold=16 if share else 10**6,
              **sampling)
    out = tpred.answer_many(frames, QUESTIONS, **kw)
    assert out == jpred.answer_many(frames, QUESTIONS, **kw)
    eng = next(reversed(tpred._engine_cache.values()))
    assert eng.prefix_prefills == (1 if share else 0)
    if not sampling:
        for q, a in zip(QUESTIONS, out):
            assert a == tpred.answer(frames, q, video_uid="clip")


def test_answer_many_reports_callback_errors(predictors):
    _, tpred, frames = predictors

    def bomb(req, new):
        raise RuntimeError("client went away")

    with pytest.warns(RuntimeWarning, match="on_tokens"):
        out = tpred.answer_many(frames, QUESTIONS[:2], video_uid="clip", on_tokens=bomb)
    assert len(out) == 2


def test_answer_many_engine_lru(predictors):
    """Engines are reused by shape, the two most recent kept."""
    _, tpred, frames = predictors
    for slots in (1, 2, 3, 2):
        tpred.answer_many(frames, QUESTIONS, video_uid="clip", num_slots=slots)
    assert [k[0] for k in tpred._engine_cache] == [3, 2]


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.7, top_k=30, top_p=0.9)],
                         ids=["greedy", "sampled"])
def test_generate_from_pixels_token_identical(params, sampling):
    jp, tp = params
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    T = 4
    req = dict(
        input_ids=rng.integers(2, 500, (1, 24)).astype(np.int32),
        image_pos=np.array([4], np.int32),
        siglip_px=rng.normal(size=(1, T, 56, 56, 3)).astype(np.float32),
        dino_px=rng.normal(size=(1, T, 56, 56, 3)).astype(np.float32),
        frame_mask=(np.arange(T) < 3)[None],
        text_len=np.array([20], np.int32),
    )
    kw = dict(max_new_tokens=6, max_len=24 + 128, max_visual_len=128, **sampling)
    ref = jax.jit(lambda p, r, key: jgen.generate(jcfg, p, **r, **kw, key=key))(
        jp, {k: jnp.asarray(v) for k, v in req.items()}, jax.random.PRNGKey(5))
    out = tgen.generate(tcfg, tp, **{k: t(v) for k, v in req.items()}, **kw,
                        key=prng.PRNGKey(5))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("sampling", [{}, dict(temperature=1.1, top_k=0, top_p=0.8)],
                         ids=["greedy", "sampled"])
def test_generate_text_only_token_identical(params, sampling):
    jp, tp = params
    ids = np.random.default_rng(2).integers(2, 100, (2, 10)).astype(np.int32)
    mask = np.arange(10)[None] < np.array([[10], [7]])
    kw = dict(max_new_tokens=8, **sampling)
    ref = jax.jit(lambda p, i, m: jgen.generate_text_only(jc.tdc_tiny(), p, i, m, **kw))(
        jp, jnp.asarray(ids), jnp.asarray(mask))
    out = tgen.generate_text_only(tc.tdc_tiny(), tp, t(ids), t(mask), **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- cli/serve.main ------------------------------------------------------------


class HFStubTokenizer:
    """StubTokenizer behind the transformers call protocol, as
    load_pretrained_model returns it."""

    bos_token_id = None

    def __init__(self):
        self._stub = StubTokenizer()

    def __call__(self, text, add_special_tokens=True):
        return types.SimpleNamespace(input_ids=self._stub.encode(text))

    def decode(self, ids, skip_special_tokens=True):
        return self._stub.decode(ids)


@pytest.fixture(scope="module")
def clip_and_ckpt(params, tmp_path_factory):
    from tdc_video_tpu_torch.convert.to_hf import save_checkpoint_dir
    from tdc_video_tpu_torch.media import build
    from tdc_video_tpu_torch.media import io as tio

    ok, msg = build.ffmpeg_libraries()
    if not ok:
        pytest.skip(f"pkg-config finds no FFmpeg libraries: {msg}")
    root = tmp_path_factory.mktemp("serve")
    ckpt = str(root / "tdc-tiny")
    save_checkpoint_dir(params[1], tc.tdc_tiny(), ckpt)
    clip = str(root / "clip.mp4")
    tio.encode_test_video(clip, w=160, h=120, fps=25.0, n_frames=200)
    return clip, ckpt


def _f32_loaders(monkeypatch):
    """Both packages' loaders return the stub tokenizer and compute in f32
    with an f32 compressor (the token-identity setting; both CLIs ask for
    bf16)."""
    from tdc_video_tpu import builder as jbuilder
    from tdc_video_tpu_torch import builder as tbuilder

    real_j, real_t = jbuilder.load_pretrained_model, tbuilder.load_pretrained_model
    asked = []

    def load_j(*a, **k):
        asked.append(("jax", k["dtype"]))
        _, m, pre, ctx = real_j(*a, **dict(k, dtype=jnp.float32, load_tokenizer=False))
        cfg = dataclasses.replace(m.cfg, compress_dtype=jnp.float32)
        return HFStubTokenizer(), jbuilder.TDCModel(cfg, m.params), pre, ctx

    def load_t(*a, **k):
        asked.append(("torch", k["dtype"]))
        _, m, pre, ctx = real_t(*a, **dict(k, dtype=torch.float32, load_tokenizer=False))
        cfg = dataclasses.replace(m.cfg, compress_dtype=torch.float32)
        return HFStubTokenizer(), tbuilder.TDCModel(cfg, m.params), pre, ctx

    monkeypatch.setattr(jbuilder, "load_pretrained_model", load_j)
    monkeypatch.setattr(tbuilder, "load_pretrained_model", load_t)
    monkeypatch.setenv("TDC_DISABLE_JAX_CACHE", "1")
    return asked


def _printed(text):
    """The CLI's stdout with its wall-clock seconds blanked."""
    return re.sub(r"\d+\.\d+s", "Xs", text)


@pytest.mark.parametrize("mode", [[], ["--chat"], ["--stream"], ["--stream", "--chat"]],
                         ids=["plain", "chat", "stream", "stream_chat"])
def test_serve_main_prints_jax_answers(clip_and_ckpt, mode, monkeypatch, capsys):
    from tdc_video_tpu.cli import serve as jserve
    from tdc_video_tpu_torch.cli import serve as tserve

    clip, ckpt = clip_and_ckpt
    asked = _f32_loaders(monkeypatch)
    argv = ["--model_path", ckpt, "--video", clip, "--bert_tokenizer", "", "--max_new_tokens",
            "4", "--slots", "2", "--max_frames", "4", "--question", "What happens?",
            "--question", "Which color is it?", *mode]
    jserve.main(argv)
    ref = _printed(capsys.readouterr().out)
    out = tserve.main(argv + ["--device", "cpu"])
    printed = _printed(capsys.readouterr().out)
    assert printed == ref
    assert asked == [("jax", jnp.bfloat16), ("torch", torch.bfloat16)]
    assert len(out["answers"]) == 2 and out["n_frames"] == 4
    for a in out["answers"]:
        assert f"A: {a}\n" in printed
    assert ("\n[q" in printed) == ("--stream" in mode)  # the streamed tokens, as JAX prints them


def test_serve_mesh_raises(tmp_path):
    from tdc_video_tpu_torch.cli import serve as tserve

    with pytest.raises(NotImplementedError, match="mesh"):
        tserve.main(["--model_path", str(tmp_path), "--video", "x.mp4", "--question", "q",
                     "--mesh", "1x2", "--device", "cpu"])
