"""Seeded traffic: synthetic videos with scene cuts, soundtracks, questions,
and a byte-level tokenizer with the configuration's chat specials (Qwen2's
unless its file says otherwise).

One generator serves every mix: a mix file (perfbench/mixes/<name>.json)
only sets its parameters.  Every draw is keyed on (seed, stream, index), so
request i of a run is the same whatever came before it, and sizes (frame
counts, token budgets) follow fixed cycles that no seed changes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

WORDS = ("the person red blue green car door table window dog street room light small large "
         "moves walks opens holds after before while near behind left right first second "
         "scene camera video shows object people bright dark fast slow outside inside kitchen "
         "ball box chair screen hand road tree water sky building music sound speaks turns").split()


def rng(seed: int, stream: str, index: int = 0) -> np.random.Generator:
    """The generator of draw `index` of a named stream under `seed`."""
    key = int.from_bytes(stream.encode(), "little")
    return np.random.default_rng([abs(int(seed)), key, int(index)])


# Qwen2's ChatML ids: the tokenizer of a configuration without a `tokenizer` block
QWEN2_SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|endoftext|>": 151643}
CHATML = ("<|im_start|>", "<|im_end|>")


class ByteTokenizer:
    """Byte b -> id byte_base + b; each special (text -> id) to its id."""

    bos_token_id = None

    def __init__(self, specials: Dict[str, int], byte_base: int = 1000):
        self.specials, self.byte_base = dict(specials), int(byte_base)

    def encode(self, text: str) -> List[int]:
        ids, i, base = [], 0, self.byte_base
        while i < len(text):
            for s, sid in self.specials.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    break
            else:
                ids.extend(base + b for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids) -> str:
        base = self.byte_base
        return bytes(int(t) - base for t in ids if base <= int(t) < base + 256).decode("utf-8", "replace")


class QwenByteTokenizer(ByteTokenizer):
    """The byte tokenizer with Qwen2's ChatML ids."""

    def __init__(self):
        super().__init__(QWEN2_SPECIALS)


def tokenizer(cfile: dict) -> ByteTokenizer:
    """The configuration file's tokenizer: its optional `tokenizer` block,
    {"specials": {text: id}} (the ChatML specials at least; every id inside
    the decoder's vocabulary and off the byte ids, `<|im_end|>` among the
    decoder's `eos_token_ids` and `<|endoftext|>` its `pad_token_id`, so
    that prompts and targets end on the ids that serving stops on), else
    Qwen2's ids."""
    block = cfile.get("tokenizer")
    if block is None:
        return QwenByteTokenizer()
    tok = ByteTokenizer(block["specials"])
    lm, base = cfile["model"]["lm"], tok.byte_base
    vocab, sp = lm["vocab_size"], tok.specials
    if (not set(CHATML) <= set(sp) or not all(0 <= i < vocab for i in list(sp.values()) + [base + 255])
            or any(base <= i < base + 256 for i in sp.values())
            or sp["<|im_end|>"] not in lm["eos_token_ids"]
            or sp.get("<|endoftext|>", lm["pad_token_id"]) != lm["pad_token_id"]):
        raise ValueError(f"tokenizer block {block!r}: needs {CHATML}, ids under {vocab} and off the "
                         f"byte ids, <|im_end|> among eos_token_ids {lm['eos_token_ids']} and "
                         f"<|endoftext|> equal to pad_token_id {lm['pad_token_id']}")
    return tok


def video(seed: int, stream: str, index: int, n_frames: int, height: int, width: int,
          cut_min: int, cut_max: int) -> np.ndarray:
    """uint8 [n, h, w, 3] at 1 fps: scenes of cut_min..cut_max frames, each a
    coarse random texture with a bright square crossing it."""
    r = rng(seed, "video:" + stream, index)
    lengths = []
    while sum(lengths) < n_frames:
        lengths.append(int(r.integers(cut_min, cut_max + 1)))
    scene = np.repeat(np.arange(len(lengths)), lengths)[:n_frames]
    coarse = r.integers(0, 256, (len(lengths), height // 8, width // 8, 3), dtype=np.uint8)
    bgs = coarse.repeat(8, axis=1).repeat(8, axis=2)
    frames = bgs[scene]
    start = np.cumsum([0] + lengths)[scene]
    pos = r.uniform(0, 1, (len(lengths), 4))
    sz = height // 5
    for t in range(n_frames):
        s, k = scene[t], t - start[t]
        y = int((pos[s, 0] * (height - sz) + 9 * k * (1 + pos[s, 2])) % (height - sz))
        x = int((pos[s, 1] * (width - sz) + 17 * k * (1 + pos[s, 3])) % (width - sz))
        frames[t, y:y + sz, x:x + sz] = 255
    return frames


def wav(seed: int, stream: str, index: int, seconds: int) -> np.ndarray:
    """`seconds` of 16 kHz mono float32: three tones whose loudness changes
    every 4 s, with noise."""
    r = rng(seed, "wav:" + stream, index)
    n = seconds * 16000
    x = np.arange(n) / 16000
    env = np.repeat(r.uniform(0.2, 1.0, (seconds // 4 + 1, 3)), 4 * 16000, axis=0)[:n]
    out = sum(0.2 * env[:, i] * np.sin(2 * np.pi * f0 * x) for i, f0 in enumerate((220.0, 440.0, 1250.0)))
    return (out + 0.03 * r.normal(size=n)).astype(np.float32)


def question(seed: int, stream: str, index: int, min_words: int, max_words: int,
             choices: int = 0) -> str:
    """A question of min_words..max_words words; with `choices`, lettered
    options and an instruction to answer with the letter."""
    r = rng(seed, stream, index)
    words = list(r.choice(WORDS, int(r.integers(min_words, max_words + 1))))
    text = " ".join(words).capitalize() + "?"
    if choices:
        opts = " ".join(f"({chr(65 + c)}) {' '.join(r.choice(WORDS, 2))}." for c in range(choices))
        text += f" Options: {opts} Answer with the option's letter."
    return text


def cycle(values: Sequence, index: int):
    return values[index % len(values)]


IGNORE_INDEX = -100
SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"


def conversation(seed: int, stream: str, index: int, n_tokens: int, tok):
    """A ChatML conversation about a video of exactly n_tokens ids: the
    system turn, a user turn holding the <image> slot (id 0) and a
    question, then assistant answers and further questions until the
    budget is spent.  Labels are the assistant turns' tokens (with their
    <|im_end|>), IGNORE_INDEX elsewhere.  Returns (ids, labels, image_pos)."""
    r = rng(seed, "text:" + stream, index)
    ids = tok.encode(SYSTEM + "<|im_start|>user\n")
    image_pos = len(ids)
    ids.append(0)
    labels = [IGNORE_INDEX] * len(ids)
    user = "\n" + " ".join(r.choice(WORDS, int(r.integers(8, 20)))) + "?"
    while len(ids) < n_tokens:
        u = tok.encode(user + "<|im_end|>\n<|im_start|>assistant\n")
        a = tok.encode(" ".join(r.choice(WORDS, int(r.integers(20, 120)))) + ".<|im_end|>")
        ids += u + a + tok.encode("\n")
        labels += [IGNORE_INDEX] * len(u) + a + [IGNORE_INDEX]
        user = "<|im_start|>user\n" + " ".join(r.choice(WORDS, int(r.integers(8, 20)))) + "?"
    return np.asarray(ids[:n_tokens], np.int64), np.asarray(labels[:n_tokens], np.int64), image_pos


def second_groups(keep: np.ndarray):
    """Per second (the frame it pools into, its place in that frame's
    group) and per frame the group size, from the keep bitmap of source
    seconds: a kept second's group is itself and the dropped seconds after
    it; leading dropped seconds pool into frame 0."""
    keep = np.asarray(keep, np.int64)
    frame_of_sec = np.maximum(np.cumsum(keep) - 1, 0)
    size = np.bincount(frame_of_sec, minlength=max(int(keep.sum()), 1)).astype(np.int32)
    pos = np.zeros(len(keep), np.int32)
    seen = {}
    for i, f in enumerate(frame_of_sec):
        pos[i] = seen.get(f, 0)
        seen[f] = pos[i] + 1
    return frame_of_sec.astype(np.int32), pos, size


def audio_arrays(w: np.ndarray, n_frames: int) -> dict:
    """The trainer's audio inputs for one sample with a frame a second: the
    10-s windows of `w` and their masks, and each second's frame, place and
    validity (the seconds past the audio pool into the last frame)."""
    n_win = max(1, -(-len(w) // 160000))
    win = np.zeros((1, n_win * 160000), np.float32)
    win[0, :len(w)] = w
    mask = np.zeros((1, n_win * 160000), bool)
    mask[0, :len(w)] = True
    S = n_win * 10
    keep = np.zeros(S, np.int64)
    keep[:min(S, n_frames)] = 1
    f, p, g = second_groups(keep)
    size = np.ones((1, n_frames), np.int32)
    size[0, :min(len(g), n_frames)] = g[:n_frames]
    return {"audio_windows": win.reshape(1, n_win, 160000), "audio_wmask": mask.reshape(1, n_win, 160000),
            "audio_frame_of_sec": np.clip(f, 0, n_frames - 1)[None].astype(np.int32),
            "audio_group_pos": p[None].astype(np.int32), "audio_group_size": size,
            "audio_sec_valid": (np.arange(S) < max(1, len(w) // 16000))[None]}
