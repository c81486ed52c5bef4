"""Port parity of the training input pipeline (train/dataset.py) on the CPU:
the same data.json through JAX's SupervisedDataset / Collator /
data_iterator and the port's gives batches bitwise equal (same keys, dtypes
and values).  The rows cover an .npy video, a PNG frame directory, an
encoded video (decoded at 1 fps by the native decoder), an image, a
text-only row, a wav beside a video, and a row whose file is missing
(it falls back to item 0); tdc_tiny(audio=True), so the audio windows and
their second groups are in the batch."""

import json
import os
import wave

import numpy as np
import pytest

from tdc_video_tpu import config as jc
from tdc_video_tpu.train import dataset as jds
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.media.io import encode_test_video
from tdc_video_tpu_torch.train import dataset as tds
from torch_parity import StubTokenizer

MAX_FRAMES = 6


def _conv(q, a):
    return [{"from": "human", "value": q}, {"from": "gpt", "value": a}]


def write_wav(path, seconds, seed=0, rate=16000):
    """A mono 16-bit wav of tones and noise."""
    rng = np.random.default_rng(seed)
    x = np.arange(int(seconds * rate)) / rate
    sig = 0.3 * np.sin(2 * np.pi * 440 * x) + 0.05 * rng.normal(size=x.shape)
    with wave.open(path, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(rate)
        fh.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    np.save(root / "clip.npy", rng.integers(0, 256, (9, 40, 56, 3), dtype=np.uint8))
    os.makedirs(root / "frames")
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (30, 24, 3), dtype=np.uint8)).save(
            root / "frames" / f"{i:03d}.png")
    Image.fromarray(rng.integers(0, 256, (36, 50, 3), dtype=np.uint8)).save(root / "img.png")
    encode_test_video(str(root / "clip.mp4"), w=64, h=48, fps=25.0, n_frames=100)
    write_wav(str(root / "clip.wav"), 13.5)
    rows = [
        {"video": "clip.npy", "audio": "clip.wav",
         "conversations": _conv("<image>\nWhat is in the video?", "Tiles and a square.")},
        {"video": "frames", "conversations": _conv("<image>\nDescribe it.", "Noise.")},
        {"image": "img.png", "conversations": _conv("<image>\nWhat colour?", "Many colours.")},
        {"conversations": _conv("Say something short.", "Something short.")},
        {"video": "clip.mp4", "conversations": _conv("<image>\nHow long is it?", "Four seconds.")},
        {"video": "missing.npy", "conversations": _conv("<image>\nGone?", "Falls back.")},
    ]
    with open(root / "data.json", "w") as fh:
        json.dump(rows, fh)
    return root


def _pipelines(root, audio=True):
    out = []
    for ds_mod, cfg in ((jds, jc.tdc_tiny(audio=audio)), (tds, tc.tdc_tiny(audio=audio))):
        ds = ds_mod.SupervisedDataset(str(root / "data.json"), cfg, StubTokenizer(),
                                      image_folder=str(root), max_frames=MAX_FRAMES)
        col = ds_mod.Collator(cfg, max_len=128, max_frames=MAX_FRAMES, max_audio_windows=2)
        out.append((ds_mod, ds, col))
    return out


def _assert_batches_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype and port[k].shape == ref[k].shape, k
        assert np.array_equal(port[k], ref[k]), k


@pytest.mark.parametrize("grouped", [True, False])
def test_data_iterator_batches_bitwise_equal(data_dir, grouped):
    """Two epochs of batches of 2 (grouped by modality and length, or
    shuffled), and a restart at step 1: every batch equal to JAX's."""
    (jmod, jset, jcol), (tmod, tset, tcol) = _pipelines(data_dir)
    kw = dict(batch_size=2, seed=3, epochs=2, group_by_modality_length=grouped)
    ref = list(jmod.data_iterator(jset, jcol, **kw))
    out = list(tmod.data_iterator(tset, tcol, **kw))
    assert len(out) == len(ref) == 6
    for o, r in zip(out, ref):
        _assert_batches_equal(o, r)
    assert any("audio_windows" in r for r in ref)
    late = list(tmod.data_iterator(tset, tcol, start_step=1, **kw))
    assert len(late) == 5
    for o, r in zip(late, ref[1:]):
        _assert_batches_equal(o, r)


def test_collator_each_row_and_fallback(data_dir):
    """Each row alone through the Collator equals JAX's (the wav row with
    its audio arrays, the text-only row with no frames); a row whose file
    is missing comes back as item 0, as in JAX."""
    (_, jset, jcol), (_, tset, tcol) = _pipelines(data_dir)
    for i in range(len(tset)):
        _assert_batches_equal(tcol([tset[i]]), jcol([jset[i]]))
    first, fell = tset[0], tset[5]
    assert fell.input_ids == first.input_ids and np.array_equal(fell.frames, first.frames)
    assert tset[4].frames.shape[0] == 4  # 4 s of video at 1 fps
    assert tset[3].frames is None and tset[0].audio_path.endswith("clip.wav")
    assert tset.lengths() == jset.lengths() and tset.modality() == jset.modality()


def test_visual_only_collator_has_no_audio(data_dir):
    """Without audio_input the batch carries no audio keys, as in JAX."""
    (_, jset, jcol), (_, tset, tcol) = _pipelines(data_dir, audio=False)
    out, ref = tcol([tset[0], tset[1]]), jcol([jset[0], jset[1]])
    _assert_batches_equal(out, ref)
    assert "audio_windows" not in out


@pytest.mark.parametrize("batch_size,seed", [(1, 0), (3, 1), (4, 7)])
def test_modality_grouped_order(batch_size, seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, 400, 37).tolist()
    modality = (rng.random(37) < 0.6).tolist()
    out = tds.modality_grouped_order(lengths, modality, batch_size, seed=seed)
    assert out == jds.modality_grouped_order(lengths, modality, batch_size, seed=seed)
    assert sorted(out) == list(range(37))


@pytest.mark.parametrize("n,cap", [(3, 8), (8, 8), (9, 8), (100, 7)])
def test_uniform_sample(n, cap):
    frames = np.arange(n)[:, None, None, None].repeat(2, 1).astype(np.uint8)
    f, keep = tds.uniform_sample(frames, cap)
    jf, jkeep = jds.uniform_sample(frames, cap)
    assert np.array_equal(f, jf) and np.array_equal(keep, jkeep) and keep.dtype == jkeep.dtype
    assert len(f) == min(n, cap) and keep.sum() == len(f)
