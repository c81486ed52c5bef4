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


QWEN2 = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|endoftext|>": 151643}
SLICED = {"<|im_start|>": 18990, "<|im_end|>": 18991, "<|endoftext|>": 18992}
LM = {"vocab_size": 19008, "eos_token_ids": [18991, 18992], "pad_token_id": 18992}


CHATML = {k: SLICED[k] for k in ("<|im_start|>", "<|im_end|>")}


@pytest.mark.parametrize("block, specials", [
    (None, QWEN2),
    ({"specials": SLICED}, SLICED),
    ({"specials": CHATML}, CHATML),
], ids=["no_block_is_qwen2", "block", "block_without_endoftext"])
def test_tokenizer_from_the_configuration_file(block, specials):
    tok = traffic.tokenizer({"model": {"lm": LM}, **({"tokenizer": block} if block else {})})
    assert tok.specials == specials
    ids = tok.encode("<|im_start|>user\nhi<|im_end|>")
    assert ids == [specials["<|im_start|>"], *(1000 + b for b in b"user\nhi"), specials["<|im_end|>"]]
    assert tok.decode(ids) == "user\nhi"


SMALL = {"<|im_start|>": 1, "<|im_end|>": 2, "<|endoftext|>": 3}


@pytest.mark.parametrize("lm, block", [
    (LM, {"specials": {"<|im_start|>": 18990, "<|endoftext|>": 18992}}),
    (LM, {"specials": {**SLICED, "<|im_start|>": 19008}}),
    ({"vocab_size": 1200, "eos_token_ids": [2], "pad_token_id": 3}, {"specials": SMALL}),
    (LM, {"specials": {**SLICED, "<|endoftext|>": 1010}}),
    (LM, {"specials": {**SLICED, "<|im_end|>": 18993}}),
    (LM, {"specials": {**SLICED, "<|endoftext|>": 18991}}),
], ids=["no_im_end", "id_past_the_vocabulary", "bytes_past_the_vocabulary", "special_among_the_bytes",
        "im_end_not_an_eos", "endoftext_not_the_pad"])
def test_a_tokenizer_block_the_decoder_cannot_take_is_refused(lm, block):
    with pytest.raises(ValueError):
        traffic.tokenizer({"model": {"lm": lm}, "tokenizer": block})
