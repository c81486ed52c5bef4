"""The port's build of the native media decoder, mirroring
tests/test_media.py: probe, 1-fps sampling, the max_dim scaling, the frame
cap, encode_test_video and the segment-parallel decoder, each through
tdc_video_tpu_torch.media (its own copy of decoder.cc, built into
tdc_video_tpu_torch/_build/).  The port's decode of a clip must equal the
JAX package's bit for bit: one source, one decoder."""

import dataclasses
import os
import wave

import numpy as np
import pytest

from tdc_video_tpu.media import io as jio
from tdc_video_tpu_torch.media import build
from tdc_video_tpu_torch.media import io as tio


@pytest.fixture(scope="module")
def gif_path(tmp_path_factory):
    """12-frame 2-fps GIF, 80x48, frame i filled with value i*20."""
    from PIL import Image

    path = tmp_path_factory.mktemp("media") / "clip.gif"
    frames = [Image.new("RGB", (80, 48), (i * 20, i * 10, 255 - i * 20)) for i in range(12)]
    frames[0].save(str(path), save_all=True, append_images=frames[1:], duration=500, loop=0)
    return str(path)


@pytest.fixture(scope="module")
def mp4_path(tmp_path_factory):
    """A seekable MPEG-4 clip from the port's encoder: 160x120 at 25 fps,
    16 s, frame k flat RGB(k % 256, 3k % 256, 64)."""
    p = str(tmp_path_factory.mktemp("mp4") / "fixture.mp4")
    tio.encode_test_video(p, w=160, h=120, fps=25.0, n_frames=400)
    return p


def test_build_is_the_ports_own():
    ok, versions = build.ffmpeg_libraries()
    assert ok, versions
    lib = build.build()
    assert os.path.dirname(lib) == str(build.BUILD_DIR) and os.path.exists(lib)
    assert build.SRC.parent.parent.name == "media" and "tdc_video_tpu_torch" in str(build.SRC)


def test_probe(gif_path, mp4_path):
    info = tio.probe(gif_path)
    assert info["width"] == 80 and info["height"] == 48
    assert not info["has_audio"]
    assert tio.probe(mp4_path) == jio.probe(mp4_path)
    info = tio.probe(mp4_path)
    assert (info["width"], info["height"]) == (160, 120) and info["duration"] >= 15.9


def test_one_fps_sampling(gif_path):
    frames, ts = tio.decode_video(gif_path, fps=1.0, max_dim=64)
    assert frames.shape[0] == 6 and frames.shape[3] == 3
    assert max(frames.shape[1], frames.shape[2]) == 64  # aspect kept, longer side max_dim
    assert np.allclose(ts, np.arange(6), atol=0.3)
    reds = frames[:, 4, 4, 0].astype(int)
    assert all(b - a > 20 for a, b in zip(reds, reds[1:])), reds


def test_max_frames_cap(gif_path):
    frames, _ = tio.decode_video(gif_path, fps=2.0, max_dim=64, max_frames=5)
    assert frames.shape[0] == 5
    with pytest.raises(FileNotFoundError):
        tio.decode_video("/nonexistent.mp4")


@pytest.mark.parametrize("threads", [1, 4])
def test_mp4_matches_jax_decoder(mp4_path, threads):
    """16 frames at 1 fps, the longer side scaled to max_dim, equal to the
    JAX package's decode bit for bit."""
    f, ts = tio.decode_video(mp4_path, fps=1.0, max_dim=384, threads=threads)
    assert f.shape == (16, 288, 384, 3)
    np.testing.assert_allclose(ts, np.arange(16), atol=0.05)
    means = [float(fr[:, :, 0].mean()) for fr in f[:10]]  # red is k % 256: wraps after 10.24 s
    assert all(b > a for a, b in zip(means, means[1:])), means
    jf, jts = jio.decode_video(mp4_path, fps=1.0, max_dim=384, threads=threads)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(ts, jts)


def test_range_decode(mp4_path):
    full, _ = tio.decode_video(mp4_path, fps=1.0, max_dim=128, threads=1)
    part = tio.decode_video_range(mp4_path, 4, 8, fps=1.0, max_dim=128)
    assert part is not None and part[0].shape[0] == 4
    assert np.abs(part[0].astype(int) - full[4:8].astype(int)).mean() < 3.0


def test_audio_and_windows(tmp_path, gif_path):
    path = str(tmp_path / "tone.wav")
    sr = 44100
    t = np.arange(3 * sr) / sr
    pcm = (np.stack([0.5 * np.sin(2 * np.pi * 440 * t), 0.5 * np.sin(2 * np.pi * 880 * t)], 1)
           * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    wav = tio.load_audio(path)
    assert wav is not None and wav.dtype == np.float32 and abs(len(wav) - 48000) < 200
    np.testing.assert_array_equal(wav, jio.load_audio(path))
    assert tio.load_audio(gif_path) is None
    windows, mask = tio.window_audio(np.ones(16000 * 13, np.float32))
    assert windows.shape == (2, 160000) and mask[0].all() and mask[1].sum() == 3 * 16000


@pytest.fixture(scope="module")
def demo_ckpt(tmp_path_factory):
    from tdc_video_tpu.config import tdc_tiny
    from test_builder import write_checkpoint

    path = str(tmp_path_factory.mktemp("demo") / "tdc-tiny")
    write_checkpoint(path, tdc_tiny(), audio=False)
    return path


def _demo_args(ckpt, video, *extra):
    from tdc_video_tpu_torch.cli import demo

    return demo.parse_args(["--model_path", ckpt, "--video", video, "--bert_tokenizer", "",
                            "--max_new_tokens", "6", "--device", "cpu", *extra])


@pytest.mark.parametrize("max_frames", [None, 12], ids=["default_cap", "cap_12"])
def test_demo_answers_from_checkpoint(demo_ckpt, mp4_path, max_frames, monkeypatch):
    """cli.demo.run on the CPU against the JAX package's demo chain on the
    same checkpoint and clip: load_pretrained_model(dtype=bfloat16),
    decode_video at the config's fps capped at --max_frames, TDCPredictor
    with max_eval_frames = --max_frames, the demo's default question,
    max_new_tokens and video_uid.  The demo's load is checked to ask for
    bfloat16 compute on the requested device; both chains then compute in
    f32 with an f32 compressor, as the other token-identity tests do (in
    bfloat16 the two backends' roundings part on this random model's
    16-frame answer), and the ids must be identical (tolerance 0)."""
    import jax.numpy as jnp
    import torch

    from tdc_video_tpu import builder as jbuilder
    from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
    from tdc_video_tpu_torch import builder as tbuilder
    from tdc_video_tpu_torch.cli import demo
    from test_torch_e2e import JaxStubTokenizer
    from torch_parity import StubTokenizer

    asked = []

    def load_f32(*a, **k):
        asked.append((k["dtype"], k["device"]))
        tok, m, pre, ctx = real_load(*a, **dict(k, dtype=torch.float32))
        cfg = dataclasses.replace(m.cfg, compress_dtype=torch.float32)
        return tok, tbuilder.TDCModel(cfg, m.params), pre, ctx

    real_load = tbuilder.load_pretrained_model
    monkeypatch.setattr(tbuilder, "load_pretrained_model", load_f32)
    extra = [] if max_frames is None else ["--max_frames", str(max_frames)]
    args = _demo_args(demo_ckpt, mp4_path, *extra)
    out = demo.run(args, tokenizer=StubTokenizer())
    assert asked == [(torch.bfloat16, "cpu")]
    assert out["n_frames"] == (max_frames or 16) and 0 < len(out["ids"]) <= 6
    assert out["answer"] == StubTokenizer().decode(out["ids"])
    _, jm, _, _ = jbuilder.load_pretrained_model(demo_ckpt, load_tokenizer=False,
                                                 dtype=jnp.float32)
    jcfg = dataclasses.replace(jm.cfg, compress_dtype=jnp.float32)
    frames, ts = jio.decode_video(mp4_path, fps=jcfg.video_fps, max_frames=args.max_frames)
    pred = JaxPredictor(jcfg, jm.params, JaxStubTokenizer(), max_new_tokens=args.max_new_tokens,
                        max_eval_frames=args.max_frames)
    ref = pred.answer(frames, demo.parse_args(["--model_path", "", "--video", ""]).question,
                      frame_seconds=ts, max_new_tokens=args.max_new_tokens, video_uid=mp4_path)
    assert out["answer"] == ref


@pytest.fixture(scope="module")
def audio_demo_ckpt(tmp_path_factory):
    from tdc_video_tpu.config import tdc_tiny
    from test_builder import write_checkpoint

    path = str(tmp_path_factory.mktemp("demo_audio") / "tdc-tiny-audio")
    write_checkpoint(path, tdc_tiny(audio=True), audio=True)
    return path


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    """14 s of 16 kHz mono PCM from the standard library's wave module: a
    440 Hz tone with noise, silent after 12 s."""
    path = str(tmp_path_factory.mktemp("wav") / "track.wav")
    rng = np.random.default_rng(5)
    x = np.arange(14 * 16000) / 16000
    pcm = 0.4 * np.sin(2 * np.pi * 440 * x) + 0.05 * rng.normal(size=x.shape)
    pcm[12 * 16000:] = 0.0
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((pcm * 32767).astype(np.int16).tobytes())
    return path


@pytest.mark.parametrize("use_audio_flag", [True, False], ids=["audio_flag", "soundtrack"])
def test_demo_audio_answers_from_checkpoint(audio_demo_ckpt, mp4_path, wav_path, use_audio_flag,
                                            monkeypatch):
    """cli.demo.run on an audio-visual checkpoint against the JAX demo chain
    (decode_video, load_audio of --audio or else of the video itself,
    answer(wav=..., frame_seconds=...)), both at f32 compute with an f32
    compressor: identical ids.  The test clip has no soundtrack, so without
    --audio both chains answer from the frames alone."""
    import jax.numpy as jnp
    import torch

    from tdc_video_tpu import builder as jbuilder
    from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
    from tdc_video_tpu_torch import builder as tbuilder
    from tdc_video_tpu_torch.cli import demo
    from test_torch_e2e import JaxStubTokenizer
    from torch_parity import StubTokenizer

    def load_f32(*a, **k):
        tok, m, pre, ctx = real_load(*a, **dict(k, dtype=torch.float32))
        cfg = dataclasses.replace(m.cfg, compress_dtype=torch.float32)
        return tok, tbuilder.TDCModel(cfg, m.params), pre, ctx

    real_load = tbuilder.load_pretrained_model
    monkeypatch.setattr(tbuilder, "load_pretrained_model", load_f32)
    extra = ["--audio", wav_path] if use_audio_flag else []
    args = _demo_args(audio_demo_ckpt, mp4_path, *extra)
    out = demo.run(args, tokenizer=StubTokenizer())
    assert out["n_frames"] == 16 and 0 < len(out["ids"]) <= 6
    _, jm, _, _ = jbuilder.load_pretrained_model(audio_demo_ckpt, load_tokenizer=False,
                                                 dtype=jnp.float32)
    jcfg = dataclasses.replace(jm.cfg, compress_dtype=jnp.float32)
    assert jcfg.audio_input
    frames, ts = jio.decode_video(mp4_path, fps=jcfg.video_fps, max_frames=args.max_frames)
    wav = jio.load_audio(wav_path if use_audio_flag else mp4_path)
    assert (wav is not None) == use_audio_flag
    assert out["audio_samples"] == (None if wav is None else len(wav))
    pred = JaxPredictor(jcfg, jm.params, JaxStubTokenizer(), max_new_tokens=args.max_new_tokens,
                        max_eval_frames=args.max_frames)
    ref = pred.answer(frames, args.question, wav=wav, frame_seconds=ts,
                      max_new_tokens=args.max_new_tokens, video_uid=mp4_path)
    assert out["answer"] == ref


@pytest.mark.parametrize("flag", [["--quantize", "int8"], ["--kv_quant", "int8"],
                                  ["--spec_window", "4"], ["--profile", "logs"]],
                         ids=lambda f: f[0])
def test_demo_options_not_ported_raise(demo_ckpt, mp4_path, flag, monkeypatch, tmp_path):
    """Each serving option of the demo runs (none raises): cli.demo.run with
    --quantize int8, --kv_quant int8, --spec_window 4 or --profile LOGDIR
    answers as the JAX package's demo chain with the same option (f32
    compute and compressor, as test_demo_answers_from_checkpoint; tolerance
    0 on the ids); --profile writes its trace into LOGDIR."""
    import jax.numpy as jnp
    import torch

    from tdc_video_tpu import builder as jbuilder
    from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
    from tdc_video_tpu_torch import builder as tbuilder
    from tdc_video_tpu_torch.cli import demo
    from test_torch_e2e import JaxStubTokenizer
    from torch_parity import StubTokenizer

    real_load = tbuilder.load_pretrained_model

    def load_f32(*a, **k):
        tok, m, pre, ctx = real_load(*a, **dict(k, dtype=torch.float32))
        cfg = dataclasses.replace(m.cfg, compress_dtype=torch.float32)
        return tok, tbuilder.TDCModel(cfg, m.params), pre, ctx

    monkeypatch.setattr(tbuilder, "load_pretrained_model", load_f32)
    if flag[0] == "--profile":
        flag = [flag[0], str(tmp_path / flag[1])]
    args = _demo_args(demo_ckpt, mp4_path, *flag)
    out = demo.run(args, tokenizer=StubTokenizer())
    assert 0 < len(out["ids"]) <= 6
    if args.profile:
        assert os.path.getsize(os.path.join(args.profile, "trace.json")) > 0
    _, jm, _, _ = jbuilder.load_pretrained_model(demo_ckpt, load_tokenizer=False,
                                                 dtype=jnp.float32, quantize=args.quantize)
    jcfg = dataclasses.replace(jm.cfg, compress_dtype=jnp.float32)
    frames, ts = jio.decode_video(mp4_path, fps=jcfg.video_fps, max_frames=args.max_frames)
    pred = JaxPredictor(jcfg, jm.params, JaxStubTokenizer(), max_new_tokens=args.max_new_tokens,
                        max_eval_frames=args.max_frames, act_quant=args.quantize == "int8-all",
                        kv_quant=args.kv_quant, spec_window=args.spec_window)
    ref = pred.answer(frames, args.question, frame_seconds=ts,
                      max_new_tokens=args.max_new_tokens, video_uid=mp4_path)
    assert out["answer"] == ref
