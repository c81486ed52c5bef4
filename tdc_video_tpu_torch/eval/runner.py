"""Single-video QA predictor (port of tdc_video_tpu/eval/runner.py:
TDCPredictor.answer and what it calls).

Frames are preprocessed on the host (the JAX package's default: PIL's
bicubic chain, data/images.process_frames) or, with device_preprocess=True,
on the device.  The tokenizer is any object with `encode(text) -> List[int]`
and `decode(ids) -> str`; HFTokenizerAdapter wraps a transformers
tokenizer.  One video's features are cached under the caller's video_uid.
An audio-visual model takes the clip's waveform (`wav`, 16 kHz mono) and
the second of each frame (`frame_seconds`).  Serving options as in JAX:
an int8 KV cache (`kv_quant`), s8 x s8 prefill (`act_quant`, with int8
weights) and prompt-lookup speculative decoding (`spec_window`).  Several
questions about one video go through the continuous-batching DecodeEngine
(`answer_many`, serving/batching.py), and a conversation through one
resident cache (`chat`, serving/session.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compress import budget
from ..compress.aspect import frame_token_layout
from ..config import TDCConfig
from ..constants import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX
from ..data.conversation import conv_templates
from ..data.images import device_preprocess, frame_bucket, pad_frames, process_frames
from ..data.preprocess import tokenizer_image_token
from ..device import resolve_device, synchronize
from ..media.io import window_audio
from ..model import encode_audio, encode_frames, prepare_multimodal_from_features
from ..ops.audio import second_groups
from ..serving.generate import generate_encoded


class HFTokenizerAdapter:
    """Bridges an HF tokenizer to the encode/decode protocol (encode ->
    tokenizer(text).input_ids)."""

    def __init__(self, tok):
        self.tok = tok
        self.bos_token_id = getattr(tok, "bos_token_id", None)

    def encode(self, text: str) -> List[int]:
        return self.tok(text).input_ids

    def decode(self, ids) -> str:
        return self.tok.decode([int(i) for i in ids], skip_special_tokens=True)


def _trim_generated(ids, lm_cfg) -> List[int]:
    """Cut a greedy stream at the first EOS (exclusive)."""
    out = []
    for t in ids:
        t = int(t)
        if t in lm_cfg.eos_token_ids:
            break
        out.append(t)
    return out


def build_text(cfg: TDCConfig, tok, question: str, qformer_prompt: Optional[str] = None):
    """Prompt ids with the <image> slot as id 0, its position, and the
    Q-Former conditioning text."""
    conv = conv_templates[cfg.conv_version].copy()
    conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + question)
    conv.append_message(conv.roles[1], None)
    ids = tokenizer_image_token(conv.get_prompt(), tok,
                                bos_token_id=getattr(tok, "bos_token_id", None))
    if "llama3" in cfg.conv_version and len(ids) >= 2 and ids[0] == ids[1] == 128000:
        ids = ids[1:]  # the template already holds <|begin_of_text|>
    img = ids.index(IMAGE_TOKEN_INDEX)
    ids = [t if t != IMAGE_TOKEN_INDEX else 0 for t in ids]
    return ids, img, qformer_prompt if qformer_prompt is not None else question


def request_shape(cfg: TDCConfig, ids, n_frames: int, text_bucket: int) -> Dict[str, int]:
    """Static sizes of one request: frame bucket T, text bucket L, visual cap
    max_vis and the prefill length max_len (as the JAX compile keys)."""
    T = frame_bucket(n_frames)
    L = text_bucket
    while len(ids) > L:
        L *= 2
    max_vis = min(budget.max_visual_len(cfg, ids), T * (budget.tokens_per_frame(cfg) + 4) + 256)
    max_vis = int(np.ceil(max_vis / 128) * 128)
    return {"T": T, "L": L, "max_vis": max_vis, "max_len": L + max_vis + 8}


def prefill_shape(cfg: TDCConfig, tok, question: str, n_frames: int, max_new_tokens: int,
                  text_bucket: int = 512, max_eval_frames: int = 1000) -> Tuple[int, int]:
    """(prefill rows T, KV-cache capacity S) of one `answer` call without
    speculative decoding (which adds spec_window - 1 slots)."""
    ids, _, _ = build_text(cfg, tok, question)
    cap = min(budget.max_num_frames(cfg, ids, train=False), max_eval_frames)
    shp = request_shape(cfg, ids, min(n_frames, cap), text_bucket)
    return shp["max_len"], shp["max_len"] + max_new_tokens


def audio_request(wav: np.ndarray, T: int, frame_seconds: np.ndarray):
    """encode_audio's inputs for one clip, on the host: 10-s windows and
    their mask, the keep bitmap of the frames' seconds turned into second
    groups (each kept second with the dropped seconds after it), the group
    sizes padded with 1 (or cut) to the frame bucket T, and sec_valid
    masking the seconds past the end of the wav.  Returns (windows, wmask,
    frame_of_sec, group_pos, group_size, sec_valid)."""
    wins, wmask = window_audio(wav)
    S = wins.shape[0] * 10
    keep = np.zeros(S, np.int64)
    keep[np.clip(frame_seconds.astype(int), 0, S - 1)] = 1
    if keep.sum() == 0:
        keep[0] = 1
    f, p, g = second_groups(keep)
    if len(g) < T:
        g = np.concatenate([g, np.ones(T - len(g), np.int32)])
    g = g[:T]
    f = np.clip(f, 0, T - 1)
    sv = np.arange(S) < max(1, int(len(wav) / 16000))
    return wins, wmask, f, p, g, sv


@dataclass
class PredictorStats:
    samples: int = 0
    encode_s: float = 0.0
    audio_s: float = 0.0  # wav -> per-frame audio tokens (0 without audio)
    prefill_s: float = 0.0  # compression + splice + LM prefill
    decode_s: float = 0.0
    decode_steps: int = 0
    last_ids: List[int] = field(default_factory=list)
    last_many_ids: List[List[int]] = field(default_factory=list)  # answer_many's raw tokens


class TDCPredictor:
    """Single-video QA through the full pipeline, on `device` (CUDA unless
    the caller passes device="cpu")."""

    def __init__(
        self,
        cfg: TDCConfig,
        params: Any,
        tokenizer,
        bert_tokenizer=None,
        max_new_tokens: int = 5,
        max_eval_frames: int = 1000,
        text_bucket: int = 512,
        attn_impl: str = "flash",
        device_preprocess: bool = False,
        device=None,
        kv_quant: Optional[str] = None,  # "int8": int8 KV cache
        act_quant: bool = False,  # s8 x s8 prefill (with int8 weights)
        spec_window: int = 0,  # >= 2: prompt-lookup speculative decode
        spec_ngram: int = 3,
    ):
        self.cfg = cfg
        self.params = params
        self.tok = tokenizer
        self.bert_tok = bert_tokenizer
        self.max_new_tokens = max_new_tokens
        self.max_eval_frames = max_eval_frames
        self.text_bucket = text_bucket
        self.attn_impl = attn_impl
        # False: the host path, bit for bit the reference's processor chain;
        # True: pad, resize and normalise on the device (within tolerance)
        self.device_preprocess = device_preprocess
        self.device = resolve_device(device)
        self.kv_quant = kv_quant
        self.act_quant = act_quant
        self.spec_window = spec_window
        self.spec_ngram = spec_ngram
        self._feat_cache: Tuple[Any, Any] = (None, None)  # one video's features
        self._engine_cache: Dict[Tuple, Any] = {}  # answer_many's engines by shape, LRU
        self.stats = PredictorStats()

    def encode_video(self, frames: np.ndarray, cache_key=None):
        """uint8 frames [n, h, w, 3] -> (frame_feats [T, P, H], dino_feats,
        frame_mask [T] bool, T), T the frame bucket; padded frames are
        masked.  Cached under `cache_key` (one video)."""
        if cache_key is not None and self._feat_cache[0] == cache_key:
            return self._feat_cache[1]
        T = frame_bucket(len(frames))
        if self.device_preprocess:
            pad = T - len(frames)
            u8 = np.concatenate([frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)]) \
                if pad else np.asarray(frames)
            fmask = np.arange(T) < len(frames)
            sig, dino = device_preprocess(torch.from_numpy(u8).to(self.device), self.cfg)
        else:
            sig, dino = process_frames(list(frames), self.cfg)
            sig, dino, fmask = pad_frames(sig, dino, T)
            sig, dino = (torch.from_numpy(x).to(self.device) for x in (sig, dino))
        ff, df = encode_frames(self.cfg, self.params, sig.to(self.cfg.dtype),
                               dino.to(self.cfg.dtype), attn_impl=self.attn_impl)
        out = (ff, df, fmask, T)
        if cache_key is not None:
            self._feat_cache = (cache_key, out)
        return out

    def build_text(self, question: str, qformer_prompt: Optional[str] = None):
        return build_text(self.cfg, self.tok, question, qformer_prompt)

    def _qformer_ids(self, text: str, max_len: int = 64):
        if self.bert_tok is None:
            # no BERT tokenizer: unconditioned compression
            return np.zeros((max_len,), np.int32), np.zeros((max_len,), bool)
        enc = self.bert_tok(text, padding="max_length", truncation=True, max_length=max_len)
        return np.asarray(enc["input_ids"], np.int32), np.asarray(enc["attention_mask"], bool)

    def encode_audio_tokens(self, wav: np.ndarray, T: int,
                            frame_seconds: np.ndarray) -> torch.Tensor:
        """wav -> per-frame audio tokens [T, 50, H] (JAX :308-333)."""
        dev = self.device
        args = [torch.from_numpy(x).to(dev) for x in audio_request(wav, T, frame_seconds)]
        return encode_audio(self.cfg, self.params, *args[:5], T, sec_valid=args[5])

    def prepare(self, frames: np.ndarray, question: str, qformer_prompt: Optional[str] = None,
                wav: Optional[np.ndarray] = None, frame_seconds: Optional[np.ndarray] = None,
                max_new_tokens: Optional[int] = None, video_uid: Optional[str] = None) -> Dict[str, Any]:
        """Everything `answer` does before generation: prompt ids, frame
        resample to the token budget (frame_seconds with them), tower encode
        (cached under an explicit video_uid: id(frames) can be reused after
        garbage collection) and, for an audio-visual model given a wav, the
        audio encode (frame_seconds defaults to one frame a second).
        Returns {"ids": prompt ids, "gen": keyword arguments of
        generate_encoded}."""
        cfg = self.cfg
        ids, img_pos, qtext = self.build_text(question, qformer_prompt)
        cap = min(budget.max_num_frames(cfg, ids, train=False), self.max_eval_frames)
        feat_key = None if video_uid is None else (video_uid, frames.shape, min(cap, len(frames)))
        if len(frames) > cap:
            idx = [int(len(frames) / cap * i) for i in range(cap)]
            frames = frames[idx]
            if frame_seconds is not None:
                frame_seconds = np.asarray(frame_seconds)[idx]

        t0 = time.perf_counter()
        ff, df, fmask, T = self.encode_video(frames, cache_key=feat_key)
        synchronize(self.device)
        self.stats.encode_s = time.perf_counter() - t0
        atok = None
        if wav is not None and cfg.audio_input:
            fs = np.asarray(frame_seconds) if frame_seconds is not None else np.arange(len(frames))
            t0 = time.perf_counter()
            atok = self.encode_audio_tokens(wav, T, fs)[None].to(cfg.dtype)
            synchronize(self.device)
            self.stats.audio_s = time.perf_counter() - t0
        else:
            self.stats.audio_s = 0.0

        shp = request_shape(cfg, ids, len(frames), self.text_bucket)
        padded = np.full((shp["L"],), cfg.lm.pad_token_id, np.int64)
        padded[: len(ids)] = ids
        qids, qmask = self._qformer_ids(qtext)
        tv, qp = frame_token_layout(cfg, frames.shape[1], frames.shape[2])

        def dev(x, dtype=None):
            return torch.as_tensor(np.asarray(x), device=self.device, dtype=dtype)

        gen = dict(
            input_ids=dev(padded)[None],
            image_pos=dev([img_pos], torch.int32),
            frame_feats=ff[None],
            dino_feats=df[None],
            frame_mask=dev(fmask)[None],
            qformer_text_ids=dev(qids, torch.int64)[None],
            qformer_text_mask=dev(qmask)[None],
            audio_tokens=atok,
            text_len=dev([len(ids)], torch.int32),
            token_valid=dev(tv)[None],
            query_pool=dev(qp)[None],
            max_new_tokens=max_new_tokens or self.max_new_tokens,
            max_len=shp["max_len"],
            max_visual_len=shp["max_vis"],
        )
        return {"ids": ids, "gen": gen}

    def answer(self, frames: np.ndarray, question: str, qformer_prompt: Optional[str] = None,
               wav: Optional[np.ndarray] = None, frame_seconds: Optional[np.ndarray] = None,
               max_new_tokens: Optional[int] = None, video_uid: Optional[str] = None) -> str:
        req = self.prepare(frames, question, qformer_prompt, wav, frame_seconds, max_new_tokens,
                           video_uid)
        timings: Dict[str, float] = {}
        toks = generate_encoded(self.cfg, self.params, **req["gen"], attn_impl=self.attn_impl,
                                timings=timings, kv_quant=self.kv_quant,
                                act_quant=self.act_quant, spec_window=self.spec_window,
                                spec_ngram=self.spec_ngram)
        ids = _trim_generated(toks[0].tolist(), self.cfg.lm)
        st = self.stats
        st.samples += 1
        st.prefill_s, st.decode_s = timings["prefill_s"], timings["decode_s"]
        st.decode_steps, st.last_ids = int(timings["decode_steps"]), ids
        return self.tok.decode(ids).strip()

    # -- continuous batching --------------------------------------------------

    def pack_prompt(self, frames: np.ndarray, question, wav: Optional[np.ndarray] = None,
                    frame_seconds: Optional[np.ndarray] = None, video_uid: Optional[str] = None):
        """The packed multimodal prompt of ONE question (`question` a string
        or a (prompt, qformer_prompt) pair): prepare's template, encode
        (cached under video_uid) and audio, then compression and splice,
        cut to a multiple of 128 rows.  Returns (embeds [1, Lb, H],
        attn_mask [1, Lb], prompt ids): what answer_many and ChatSession
        build engine requests from."""
        qf = None
        if isinstance(question, tuple):
            question, qf = question
        req = self.prepare(frames, question, qf, wav, frame_seconds, video_uid=video_uid)
        gen = {k: v for k, v in req["gen"].items() if k != "max_new_tokens"}
        mm = prepare_multimodal_from_features(self.cfg, self.params, **gen)
        Lb = int(np.ceil(max(int(mm["seq_len"][0]), 1) / 128) * 128)
        return mm["embeds"][:, :Lb], mm["attn_mask"][:, :Lb], np.asarray(req["ids"], np.int32)

    def chat(self, frames: np.ndarray, **kw):
        """A multi-turn conversation over one video: the first ask() packs and
        prefills the prompt, every later ask() extends the same KV cache by
        its own tokens (serving/session.ChatSession)."""
        from ..serving.session import ChatSession

        return ChatSession(self, frames, **kw)

    def _shared_prefix_len(self, prefixes) -> int:
        """The longest common embed prefix of the packed prompts, capped one
        below the shortest valid length.  Compared on the device, one scalar
        read a pair."""
        e0 = prefixes[0][0]
        lim = int(prefixes[0][1].sum()) - 1
        for e, m, _ in prefixes[1:]:
            n = min(e0.shape[1], e.shape[1])
            eq = (e0[:, :n] == e[:, :n]).all(dim=-1)[0]
            # the first mismatch; the appended one makes a full match give n
            ne = torch.cat([~eq, eq.new_ones((1,))])
            lim = min(lim, int(m.sum()) - 1, int(torch.argmax(ne.to(torch.int8))))
        return max(lim, 0)

    def answer_many(
        self,
        frames: np.ndarray,
        questions: Sequence,  # strings, or (prompt, qformer_prompt) pairs
        wav: Optional[np.ndarray] = None,
        frame_seconds: Optional[np.ndarray] = None,
        max_new_tokens: Optional[int] = None,
        video_uid: Optional[str] = None,
        num_slots: int = 4,
        kv_quant: Optional[str] = None,
        prefix_share_threshold: int = 256,
        prefill_chunk: int = 0,
        on_tokens=None,  # callable(req, new_token_ids); req.uid is the question's index
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 1.0,
        seed: int = 0,  # question i samples with seed + i
    ) -> List[str]:
        """Answer several questions about ONE video through the
        continuous-batching DecodeEngine: the towers run once (video_uid's
        feature cache), each question compresses and prefills into its own
        slot, and all decodes share one lockstep loop.  When the packed
        prompts share at least prefix_share_threshold leading rows (the
        template head and the video tokens, with an unconditioned
        Q-Former), that prefix is prefilled once and each question extends
        only its suffix."""
        from ..serving.batching import DecodeEngine, Request

        cfg = self.cfg
        mnt = max_new_tokens or self.max_new_tokens
        prefixes = []
        for q in questions:
            embeds, amask, pids = self.pack_prompt(frames, q, wav=wav, frame_seconds=frame_seconds,
                                                   video_uid=video_uid)
            prefixes.append((embeds, amask.cpu().numpy(), pids))
        shared_p = self._shared_prefix_len(prefixes) if len(prefixes) > 1 else 0
        if shared_p < prefix_share_threshold:
            shared_p = 0
        spec_window = self.spec_window
        # keep the whole mnt budget beside the window - 1 rows of verify headroom
        cap_pad = mnt + max(spec_window - 1, 0)
        capacity = int(np.ceil((max(p[0].shape[1] for p in prefixes) + cap_pad) / 128) * 128)
        slots = min(num_slots, len(prefixes))
        kvq = kv_quant or self.kv_quant
        ekey = (slots, capacity, kvq, prefill_chunk, spec_window)
        eng = self._engine_cache.pop(ekey, None)
        if eng is None:
            eng = DecodeEngine(cfg, self.params, num_slots=slots, capacity=capacity,
                               attn_impl=self.attn_impl, kv_quant=kvq, act_quant=self.act_quant,
                               spec_window=spec_window, spec_ngram=self.spec_ngram,
                               prefill_chunk=prefill_chunk, on_tokens=on_tokens,
                               device=self.device)
        else:
            eng.reset(on_tokens=on_tokens)
        # LRU: the 2 most recent shapes stay (each holds a slots x capacity cache)
        self._engine_cache[ekey] = eng
        while len(self._engine_cache) > 2:
            self._engine_cache.pop(next(iter(self._engine_cache)))
        for i, (embeds, mask, pids) in enumerate(prefixes):
            eng.submit(Request(embeds=embeds, attn_mask=mask, max_new_tokens=mnt, uid=i,
                               prompt_ids=pids, prefix_key="video" if shared_p else None,
                               prefix_len=shared_p, temperature=temperature, top_k=top_k,
                               top_p=top_p, seed=seed + i))
        done = eng.run()
        if eng.on_tokens_errors:
            # the engine isolates callback errors so that decoding finishes;
            # a broken stream consumer is still reported
            import warnings

            warnings.warn(f"{len(eng.on_tokens_errors)} on_tokens callback error(s) during "
                          f"answer_many; first: {eng.on_tokens_errors[0]!r}", RuntimeWarning,
                          stacklevel=2)
        by_uid = {r.uid: r for r in done}
        self.stats.last_many_ids = [list(by_uid[i].tokens) for i in range(len(prefixes))]
        return [self.tok.decode(_trim_generated(by_uid[i].tokens, cfg.lm)).strip()
                for i in range(len(prefixes))]

