"""The reference's judgement of a served request: it rebuilds the prompt,
the request's sizes, the frame tokens, the scene cuts, the compressed
visual tokens and the spliced sequence from the request's own inputs, runs
the decoder over the prompt and the served tokens, and reads how far each
served token's logit lies below its position's best (`token_gap`).

Scene cuts are a discrete choice among frame pairs whose similarities can
tie to rounding, as greedy tokens are: the port's cuts are judged the same
way (`cut_gap`: how far its most similar cut pair lies above the least
similar pair it left), and the reference then compresses along them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import core
from . import model as R

SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
FRAME_BUCKETS = (8, 16, 32, 64, 128, 224, 448, 1000)


@contextlib.contextmanager
def exact_f32():
    """Float32 products in full float32 (no TF32) while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def prompt_ids(tok, question: str):
    """ChatML prompt ids with the <image> slot as id 0, and its position."""
    head = SYSTEM + "<|im_start|>user\n"
    tail = "\n" + question + "<|im_end|>\n<|im_start|>assistant\n"
    a, b = tok.encode(head), tok.encode(tail)
    return a + [0] + b, len(a)


def sizes(m, ids: Sequence[int], n_frames: int, max_eval_frames: int = 1000) -> Dict[str, int]:
    """The request's frame cap, frame bucket and visual cap, from the token
    budget: tokens a frame = (static + K (n - 1)) // n for chunks of n."""
    c = m.compression
    static = m.sva.image_token_len + (50 if m.audio_input else 0)
    tpf = (static + c.context_token_num * (c.chunk_size - 1)) // c.chunk_size
    tlen = next((i for i, t in enumerate(ids) if t == m.lm.pad_token_id), len(ids))
    budget = m.tokenizer_model_max_length - tlen - m.inference_max_length
    cap = min(max(1, min(budget // tpf, c.max_eval_frames)), max_eval_frames)
    T = next(b for b in FRAME_BUCKETS if min(n_frames, cap) <= b)
    max_vis = min(max(1, budget), T * (tpf + 4) + 256)
    return {"cap": cap, "T": T, "max_visual": int(math.ceil(max_vis / 128) * 128)}


def resampled(m, ids, frames: np.ndarray) -> np.ndarray:
    """The frames a request keeps: all, or evenly spaced ones down to its
    frame cap."""
    cap = sizes(m, ids, len(frames))["cap"]
    if len(frames) > cap:
        frames = frames[[int(len(frames) / cap * i) for i in range(cap)]]
    return frames


def visual_tokens(m, params, frames: np.ndarray, port_cuts: Optional[np.ndarray],
                  ids, P: R.Prec = R.F32, device="cuda", encoded=None):
    """(visual tokens [n, H], cut_gap or None, the cuts used, the adjacent
    similarities) of one request: the port's cuts when given (judged), else
    the reference's own.  `encoded`: encode_frames' result for these
    frames at this precision, when the caller has it."""
    frames = resampled(m, ids, frames)
    sz = sizes(m, ids, len(frames))
    if len(frames) != sz["T"]:
        raise ValueError(f"{len(frames)} frames fill no bucket; the reference takes whole buckets")
    if encoded is None:
        encoded = R.encode_frames(m, params, torch.from_numpy(np.ascontiguousarray(frames)).to(device), P)
    ftok, dino = encoded
    sims = R.adjacent_similarity(dino)
    ms = m.compression.max_num_segments
    gap = None
    if port_cuts is None:
        cuts = R.scene_cuts(sims, len(frames), ms).cpu().numpy()
    else:
        cuts = np.asarray(port_cuts, bool)
        gap = R.cut_gap(sims, torch.from_numpy(cuts).to(sims.device), ms)
    side = int(m.sva.image_token_len ** 0.5)
    valid, pool = R.token_layout(side, frames.shape[1], frames.shape[2], m.compression.context_token_num)
    vis = R.compress(m, params["compressor"], ftok, R.chunks_of(cuts, m.compression.chunk_size),
                     valid, pool, sz["max_visual"], P)
    return vis, gap, cuts, sims


def logits_over(m, params, prompt: torch.Tensor, tokens: Sequence[int], P: R.Prec = R.F32):
    """Decoder logits [len(tokens), V] for each served token's position:
    the prompt's last row, then each served token but the last fed back
    (the decoder of the configuration's family)."""
    lm = core.lm_family(m)
    if len(tokens) > 1:
        prompt = torch.cat([prompt, lm.embed(m.lm, params["lm"], list(tokens[:-1]), P)])
    n0 = prompt.shape[0] - (len(tokens) - 1)
    rows = torch.arange(n0 - 1, n0 - 1 + len(tokens), device=prompt.device)
    return lm.logits(m.lm, params["lm"], prompt, rows, P)


def token_gaps(logits: torch.Tensor, tokens: Sequence[int], eos_last: bool, eos_ids) -> torch.Tensor:
    """served_gaps, where a last token known only as "an EOS" is judged by
    the best EOS id."""
    gaps = R.served_gaps(logits[:len(tokens) - int(eos_last)], tokens[:len(tokens) - int(eos_last)])
    if eos_last:
        row = logits[len(tokens) - 1]
        gaps = torch.cat([gaps, (row.max() - row[list(eos_ids)].max())[None]])
    return gaps


def served(m, tokens: Sequence[int], max_new: int):
    """(tokens to judge, whether the last is an EOS known only as such): a
    trimmed answer shorter than its budget ended on an EOS."""
    toks = list(tokens)
    eos = m.lm.eos_token_ids
    if toks and toks[-1] in eos:
        return toks, False
    if len(toks) < max_new:
        return toks + [eos[0]], True
    return toks, False


def encode(m, params, frames: np.ndarray, P: R.Prec = R.F32, device="cuda"):
    """The reference's frame tokens and DINOv2 features of a video."""
    with exact_f32(), torch.no_grad():
        return R.encode_frames(m, params, torch.from_numpy(np.ascontiguousarray(frames)).to(device), P)


def judge(m, params, tok, frames: np.ndarray, question: str, tokens: Sequence[int],
          max_new: int, port_cuts, device="cuda", encoded=None) -> Dict[str, float]:
    """The reference's reading of one served request: the widest token gap,
    the cut gap and how many tokens were judged.  `encoded`: encode()'s
    result for these frames, shared by questions about one video."""
    with exact_f32(), torch.no_grad():
        ids, img = prompt_ids(tok, question)
        vis, cgap, _, _ = visual_tokens(m, params, frames, port_cuts, ids, R.F32, device, encoded)
        toks, eos_last = served(m, tokens, max_new)
        prompt = R.spliced_prompt(m, params, ids, img, vis, R.F32)
        lg = logits_over(m, params, prompt, toks, R.F32)
        gaps = token_gaps(lg, toks, eos_last, m.lm.eos_token_ids)
    return {"token_gap": float(gaps.max()), "cut_gap": float(cgap), "tokens": len(toks),
            "visual": int(vis.shape[0])}


def control(m, params, tok, frames: np.ndarray, question: str, tokens: Sequence[int],
            max_new: int, port_cuts, device="cuda", encoded=None) -> Dict[str, float]:
    """The control: the reference in bf16 with fp8 weights in the program's
    place, at each position of the same prompt and served tokens; its top
    token there read under the float32 reference (its widest gap), and its
    own cuts judged as the port's are."""
    with exact_f32(), torch.no_grad():
        ids, img = prompt_ids(tok, question)
        toks, _ = served(m, tokens, max_new)
        vis32, _, _, sims = visual_tokens(m, params, frames, port_cuts, ids, R.F32, device, encoded)
        ref = logits_over(m, params, R.spliced_prompt(m, params, ids, img, vis32, R.F32), toks, R.F32)
        Pc = R.Prec(torch.bfloat16, fp8=True)
        visc, _, cuts_c, _ = visual_tokens(m, params, frames, None, ids, Pc, device)
        lc = logits_over(m, params, R.spliced_prompt(m, params, ids, img, visc, Pc), toks, Pc)
        top = lc.argmax(-1)
        cgap = R.cut_gap(sims, torch.from_numpy(cuts_c).to(sims.device), m.compression.max_num_segments)
    return {"token_gap": float(R.served_gaps(ref, top.tolist()).max()), "cut_gap": float(cgap),
            "tokens": len(toks)}
