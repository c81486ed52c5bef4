"""The port's audio path against the JAX package, on the CPU in f32: the
Kaldi fbank, BEATs, the audio/frame alignment, encode_audio, and
TDCPredictor.answer with a waveform on tdc_tiny(audio=True).

Tolerances: the fbank's log-mel 1e-3 absolute (two FFT libraries: a 10-s
tone with noise and a silent tail differs by at most 5.8e-4); the numpy
helpers bitwise; per-second slicing and pooling 1e-6; patch embed, the
positional conv and beats_forward the golden suite's 2e-4 absolute, 3e-4
relative; encode_audio 2e-4 absolute and relative (the fbank's difference
carried through BEATs and audio_proj: at most 4.5e-6 here at tdc_tiny, on
outputs up to 3.1; BEATs base alone, from the two packages' fbanks, 1.2e-5
on outputs up to 4.0); answer() token-identical, its prefill logits within
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.models import beats as jb
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.ops import audio as ja
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tm
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.models import beats as tb
from tdc_video_tpu_torch.ops import audio as ta
from tdc_video_tpu_torch.serving.generate import prefill_encoded
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer, close, t, to_torch

FBANK_ATOL = 1e-3
BEATS_ATOL, BEATS_RTOL = 2e-4, 3e-4
POOL_TOL = 1e-6
# encode_audio end to end, port vs JAX, f32 (also chip_smoke.py's bound for
# the card against the host CPU)
ENCODE_AUDIO_TOL = 2e-4
LOGITS_TOL = 1e-4


def tone_wav(seconds: float, seed: int = 0, silent_from: float = None) -> np.ndarray:
    """16 kHz mono: a 440 Hz and a 1 kHz tone with noise, silent from
    `silent_from` seconds on."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    x = np.arange(n) / 16000
    wav = 0.3 * np.sin(2 * np.pi * 440 * x) + 0.1 * np.sin(2 * np.pi * 1000 * x)
    wav = (wav + 0.05 * rng.normal(size=n)).astype(np.float32)
    if silent_from is not None:
        wav[int(silent_from * 16000):] = 0.0
    return wav


# ---------------------------------------------------------------------------
# Fbank
# ---------------------------------------------------------------------------


def test_fbank_helpers_bitwise():
    np.testing.assert_array_equal(ta.mel_banks(), ja.mel_banks())
    np.testing.assert_array_equal(ta._povey_window(), ja._povey_window())
    for n in (0, 399, 400, 401, 16000, 160000, 160159):
        assert ta.num_fbank_frames(n) == ja.num_fbank_frames(n)


def test_kaldi_fbank_matches_jax():
    """A 10-s window and its reverse (silence first); silent frames give
    exactly log(EPSILON)."""
    wav = tone_wav(10.0, silent_from=7.5)
    w = np.stack([wav, wav[::-1].copy()])
    ref = np.asarray(ja.kaldi_fbank(jnp.asarray(w)))
    out = ta.kaldi_fbank(t(w))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 998, 128)
    close(out, ref, atol=FBANK_ATOL, rtol=0)
    floor = np.log(np.float32(ta.EPSILON))
    silent = out[0, ta.num_fbank_frames(120000 + 400):]
    assert silent.shape[0] > 200 and bool((silent == floor).all())


def test_kaldi_fbank_f32_under_bf16_input():
    wav = tone_wav(2.0, seed=1)
    out = ta.kaldi_fbank(t(wav[None]).to(torch.bfloat16))
    ref = ja.kaldi_fbank(jnp.asarray(wav[None], jnp.bfloat16))
    assert out.dtype == torch.float32
    close(out, ref, atol=FBANK_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,nb,md", [(16, 32, 64), (496, 320, 800), (7, 320, 800)])
def test_relative_position_buckets_bitwise(T, nb, md):
    np.testing.assert_array_equal(tb.relative_position_buckets(T, nb, md),
                                  jb.relative_position_buckets(T, nb, md))


KEEPS = {
    "every_second": [1] * 10,
    "groups_2_3": [1, 0, 1, 0, 0, 1, 1, 0, 1, 0],
    "leading_dropped": [0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 0, 0],
    "none_kept": [0, 0, 0, 0],
}


@pytest.mark.parametrize("keep", list(KEEPS.values()), ids=list(KEEPS))
def test_second_groups_bitwise(keep):
    for a, b in zip(ta.second_groups(np.array(keep)), ja.second_groups(np.array(keep))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_tokens", [496, 500, 320, 40])
def test_window_to_seconds(n_tokens):
    """496 tokens (second 9 pooled up from 46), a full 500, and windows
    whose last seconds are short or empty."""
    x = np.random.default_rng(n_tokens).normal(size=(2, n_tokens, 8)).astype(np.float32)
    close(ta.window_to_seconds(t(x)), ja.window_to_seconds(jnp.asarray(x)), atol=POOL_TOL,
          rtol=POOL_TOL)


@pytest.mark.parametrize("keep", list(KEEPS.values()), ids=list(KEEPS))
@pytest.mark.parametrize("valid_secs", [None, 7])
def test_pool_seconds_to_frames(keep, valid_secs):
    """Group sizes above 1, leading dropped seconds pooled into frame 0,
    seconds past the end of the audio masked; num_frames past the kept
    count (group size padded with 1, as the predictor pads to its frame
    bucket)."""
    keep = np.array(keep)
    S = len(keep)
    f, p, g = ja.second_groups(keep)
    T = max(int(keep.sum()), 1) + 2
    g = np.concatenate([g, np.ones(T - len(g), np.int32)])
    per_sec = np.random.default_rng(S).normal(size=(S, 50, 6)).astype(np.float32)
    sv = None if valid_secs is None else np.arange(S) < valid_secs
    ref = ja.pool_seconds_to_frames(jnp.asarray(per_sec), jnp.asarray(f), jnp.asarray(p),
                                    jnp.asarray(g), T, None if sv is None else jnp.asarray(sv))
    out = ta.pool_seconds_to_frames(t(per_sec), t(f), t(p), t(g), T, None if sv is None else t(sv))
    assert out.shape == (T, 50, 6)
    close(out, ref, atol=POOL_TOL, rtol=POOL_TOL)


# ---------------------------------------------------------------------------
# BEATs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def beats_params():
    jp = jb.init_beats(jax.random.PRNGKey(0), jc.BEATS_TINY)
    return jp, to_torch(jp)


def _fbank_input(seed=0):
    """One fbank, computed once (by JAX) and fed to both packages."""
    wav = tone_wav(10.0, seed=seed, silent_from=8.0)
    return np.asarray(ja.kaldi_fbank(jnp.asarray(np.stack([wav, wav[::-1].copy()]))))


def test_patch_embed_and_pos_conv(beats_params):
    jp, tp = beats_params
    fb = _fbank_input()
    cfg_j, cfg_t = jc.BEATS_TINY, tc.BEATS_TINY
    ref = jb.patch_embed(cfg_j, jp, jnp.asarray(fb))
    out = tb.patch_embed(cfg_t, tp, t(fb))
    assert out.shape == (2, 496, cfg_t.embed_dim)
    close(out, ref, atol=BEATS_ATOL, rtol=BEATS_RTOL)
    x = np.random.default_rng(1).normal(size=(2, 496, cfg_t.encoder_embed_dim)).astype(np.float32)
    close(tb._pos_conv(tp, t(x)), jb._pos_conv(jp, jnp.asarray(x)), atol=BEATS_ATOL,
          rtol=BEATS_RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_beats_forward(beats_params, masked):
    """The whole encoder on one fbank, without and with a padding mask
    (the first window padded from frame 700 on: rows 43+ masked)."""
    jp, tp = beats_params
    fb = _fbank_input(seed=2)
    mask = np.stack([np.arange(998) < 700, np.ones(998, bool)]) if masked else None
    ref, ref_mask = jb.beats_forward(jc.BEATS_TINY, jp, jnp.asarray(fb),
                                     None if mask is None else jnp.asarray(mask))
    out, out_mask = tb.beats_forward(tc.BEATS_TINY, tp, t(fb), None if mask is None else t(mask))
    close(out, ref, atol=BEATS_ATOL, rtol=BEATS_RTOL)
    if masked:
        np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
        assert not bool(out_mask[0].all()) and bool(out_mask[1].all())
    else:
        assert out_mask is None and ref_mask is None


def test_compute_position_bias(beats_params):
    jp, tp = beats_params
    close(tb.compute_position_bias(tp, tc.BEATS_TINY, 40),
          jb.compute_position_bias(jp, jc.BEATS_TINY, 40), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# encode_audio and answer() on tdc_tiny(audio=True)
# ---------------------------------------------------------------------------


def _cfgs():
    return (dataclasses.replace(jc.tdc_tiny(audio=True), compress_dtype=jnp.float32),
            dataclasses.replace(tc.tdc_tiny(audio=True), compress_dtype=torch.float32))


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny(audio=True))
    return jp, to_torch(jp)


def test_config_with_audio():
    for preset in ("tdc_qwen2_7b", "tdc_llama32_3b", "tdc_tiny"):
        j, p = getattr(jc, preset)(audio=True), getattr(tc, preset)(audio=True)
        assert p.audio_input and p.compression.audio_input
        assert p.tokens_per_frame() == j.tokens_per_frame()
        assert dataclasses.asdict(p.beats) == dataclasses.asdict(j.beats)
        assert not getattr(tc, preset)().audio_input


def test_init_tdc_audio_tree(params):
    """init_tdc adds beats and audio_proj, with JAX's shapes."""
    jp, _ = params
    port = tm.init_tdc(tc.tdc_tiny(audio=True), torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree_util.tree_map(lambda x: tuple(x.shape), {k: jp[k] for k in ("beats", "audio_proj")})
    got = {k: port[k] for k in ("beats", "audio_proj")}
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), got) == ref


def test_encode_audio_matches_jax(params):
    """18 s of audio (two windows, the second half padding), frames at
    seconds 0, 2, 3, 7, 11, 15 in a bucket of 8, seconds past 18 masked."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    wav = tone_wav(18.0, seed=3, silent_from=15.0)
    wins, wmask = np.zeros((2, 160000), np.float32), np.zeros((2, 160000), bool)
    wins.reshape(-1)[: len(wav)], wmask.reshape(-1)[: len(wav)] = wav, True
    keep = np.zeros(20, np.int64)
    keep[[0, 2, 3, 7, 11, 15]] = 1
    f, p, g = ja.second_groups(keep)
    T = 8
    g = np.concatenate([g, np.ones(T - len(g), np.int32)])
    sv = np.arange(20) < 18
    ref = jmodel.encode_audio(jcfg, jp, *(jnp.asarray(x) for x in (wins, wmask, f, p, g)), T,
                              jnp.asarray(sv))
    out = tm.encode_audio(tcfg, tp, *(t(x) for x in (wins, wmask, f, p, g)), T, t(sv))
    assert out.shape == (T, 50, tcfg.lm.hidden_size)
    close(out, ref, atol=ENCODE_AUDIO_TOL, rtol=ENCODE_AUDIO_TOL)


def _frames(n, seed=3):
    frames = np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3), dtype=np.uint8)
    frames[n // 2:, :, :32] = 255 - frames[n // 2:, :, :32]  # a visible change mid-clip
    return frames


# (frames, frame_seconds, wav seconds)
ANSWER_CASES = {
    "one_fps": (12, np.arange(12, dtype=np.float64), 12.0),
    "dropped_seconds": (6, np.array([0.0, 2.0, 5.0, 7.0, 10.0, 12.0]), 15.0),
    "wav_shorter_than_video": (12, np.arange(12, dtype=np.float64), 7.5),
    "frames_over_cap": (20, np.arange(20, dtype=np.float64), 20.0),
}


@pytest.mark.parametrize("case", list(ANSWER_CASES), ids=list(ANSWER_CASES))
def test_answer_with_wav_token_identical(params, case):
    """TDCPredictor.answer(frames, q, wav=..., frame_seconds=...) in both
    packages: the same ids (the prompt is long enough that the frame cap
    is tdc_tiny's 16, so 20 frames are resampled with their seconds), and
    the prefill logits of the same request within LOGITS_TOL."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    n, fs, secs = ANSWER_CASES[case]
    frames, wav = _frames(n), tone_wav(secs, seed=n, silent_from=secs - 2.0)
    jpred = JaxPredictor(jcfg, jp, JaxStubTokenizer(), max_new_tokens=8, text_bucket=128)
    tpred = TorchPredictor(tcfg, tp, StubTokenizer(), max_new_tokens=8, text_bucket=128,
                           device="cpu")
    q = "What do you hear and see?"
    ref = jpred.answer(frames, q, wav=wav, frame_seconds=fs)
    out = tpred.answer(frames, q, wav=wav, frame_seconds=fs)
    assert out == ref
    assert tpred.stats.audio_s > 0

    req = tpred.prepare(frames, q, wav=wav, frame_seconds=fs)
    gen = req["gen"]
    assert gen["audio_tokens"].shape[:3] == (1, gen["frame_mask"].shape[1], 50)
    logits, _ = prefill_encoded(tcfg, tp, **gen)
    # the JAX side from its own encode of frames and audio
    ids, img_pos, _ = jpred.build_text(q)
    cap = 16
    fr, fsec = (frames, fs) if n <= cap else (frames[[int(n / cap * i) for i in range(cap)]],
                                             fs[[int(n / cap * i) for i in range(cap)]])
    ff, df, fmask, T = jpred.encode_video(fr)
    atok = jpred.encode_audio_tokens(wav, T, fsec)
    mm = jmodel.prepare_multimodal_from_features(
        jcfg, jp, jnp.asarray(gen["input_ids"].numpy()), jnp.asarray([img_pos], jnp.int32),
        ff[None], df[None], jnp.asarray(fmask)[None], jnp.asarray(gen["qformer_text_ids"].numpy()),
        jnp.asarray(gen["qformer_text_mask"].numpy()), audio_tokens=atok[None],
        text_len=jnp.asarray([len(ids)], jnp.int32),
        token_valid=jnp.asarray(gen["token_valid"].numpy()),
        query_pool=jnp.asarray(gen["query_pool"].numpy()), max_len=gen["max_len"],
        max_visual_len=gen["max_visual_len"])
    cache = jlm.init_kv_cache(jcfg.lm, 1, gen["max_len"] + 8, dtype=jnp.float32)
    ref_logits, _ = jlm.prefill(jcfg.lm, jp["lm"], mm["embeds"], mm["attn_mask"], cache,
                                attn_impl="flash", dtype=jnp.float32)
    close(logits, ref_logits, atol=LOGITS_TOL, rtol=0)


def test_answer_ignores_wav_without_audio_model():
    """A visual-only model answers the same with and without a wav, as in
    the JAX package (the wav is used only when cfg.audio_input)."""
    cfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    p = tm.init_tdc(cfg, torch.Generator().manual_seed(1), device="cpu")
    pred = TorchPredictor(cfg, p, StubTokenizer(), max_new_tokens=4, text_bucket=128, device="cpu")
    frames = _frames(6)
    a = pred.answer(frames, "What happens?")
    assert pred.answer(frames, "What happens?", wav=tone_wav(6.0)) == a
    assert pred.stats.audio_s == 0.0
