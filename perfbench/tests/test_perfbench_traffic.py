"""The traffic generators: the same seed gives the same inputs, another seed
other contents at the same sizes, and the frame-count cycles are fixed."""

import numpy as np
import pytest

from perfbench import traffic

SEEDS = [0, 2**31 + 5, 123456789]


@pytest.mark.parametrize("seed", SEEDS)
def test_video_is_a_function_of_seed_stream_and_index(seed):
    a = traffic.video(seed, "window", 3, 32, 72, 128, 8, 30)
    assert a.shape == (32, 72, 128, 3) and a.dtype == np.uint8
    assert np.array_equal(a, traffic.video(seed, "window", 3, 32, 72, 128, 8, 30))
    assert not np.array_equal(a, traffic.video(seed + 1, "window", 3, 32, 72, 128, 8, 30))
    assert not np.array_equal(a, traffic.video(seed, "warmup", 3, 32, 72, 128, 8, 30))


def test_scenes_cut_where_the_texture_changes():
    v = traffic.video(7, "window", 0, 64, 72, 128, 8, 30).astype(np.float32)
    jumps = np.abs(np.diff(v, axis=0)).mean(axis=(1, 2, 3))
    cuts = np.nonzero(jumps > 40)[0]
    assert 2 <= len(cuts) <= 8 and np.diff(cuts).min() >= 7


@pytest.mark.parametrize("seed", SEEDS)
def test_questions_and_wav(seed):
    q = traffic.question(seed, "window", 1, 20, 60, choices=4)
    words = q.split(" Options:")[0].split()
    assert 20 <= len(words) <= 60 and "(D)" in q
    assert q == traffic.question(seed, "window", 1, 20, 60, choices=4)
    w = traffic.wav(seed, "window", 0, 3)
    assert w.shape == (48000,) and w.dtype == np.float32
    assert np.array_equal(w, traffic.wav(seed, "window", 0, 3))


def test_frame_cycle_does_not_depend_on_the_seed():
    frames = [32, 64, 128, 224]
    assert [traffic.cycle(frames, i) for i in range(6)] == [32, 64, 128, 224, 32, 64]


def test_tokenizer_maps_chatml_specials():
    tok = traffic.QwenByteTokenizer()
    ids = tok.encode("<|im_start|>user\nhi<|im_end|>")
    assert ids[0] == 151644 and ids[-1] == 151645
    assert tok.decode(ids) == "user\nhi"
