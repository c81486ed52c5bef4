"""Multi-turn conversation over one video with one resident KV cache (port
of tdc_video_tpu/serving/session.py).

The first ask() packs the video prompt and prefills it once; every later
ask() feeds only the new turn's tokens (template glue and question) on top
of the finished turn's KV, which the DecodeEngine snapshots at finish
(Request.keep_prefix) and admits again as a shared-prefix donor
(models/lm.extend_prefill).

Token bookkeeping: the engine commits KV for the prompt and for every
generated token but the last (a token's KV is written when it is fed back,
and the final or EOS token never is).  Request.kv_len is the committed
length; the next turn feeds the uncommitted tail before its own tokens, so
the cache holds exactly what a from-scratch prefill of the whole
conversation would build.

A predictor with a mesh runs the session over it (every rank asks the same
questions): the embeddings and the engine take the predictor's mesh.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..data.conversation import SeparatorStyle, conv_templates
from ..models import lm as lm_mod


def follow_up_text(cfg, question: str, closed: bool) -> str:
    """The template glue between a finished assistant turn and the next
    user question, per conversation family.  `closed`: the answer already
    ended with the template's EOS/sep token; an answer cut by the token
    budget needs the separator from the glue."""
    conv = conv_templates[cfg.conv_version]
    head = "" if closed else conv.sep
    if conv.sep_style == SeparatorStyle.CHATML:
        return (head + "\n" + conv.roles[0] + "\n" + question + conv.sep + "\n"
                + conv.roles[1] + "\n")
    if conv.sep_style == SeparatorStyle.LLAMA_3:
        return (head + f"<|start_header_id|>{conv.roles[0]}<|end_header_id|>\n\n" + question
                + conv.sep + f"<|start_header_id|>{conv.roles[1]}<|end_header_id|>\n\n")
    return head + question + conv.sep  # plain: messages joined by sep


def encode_plain(tok, text: str) -> List[int]:
    """Tokenize without special tokens (a follow-up must not pick up a BOS
    mid-conversation; Llama tokenizers add one by default)."""
    inner = getattr(tok, "tok", None)
    if inner is not None:
        try:
            return list(inner(text, add_special_tokens=False).input_ids)
        except TypeError:
            pass  # tokenizers without the keyword
    return list(tok.encode(text))


class ChatSession:
    """Multi-turn QA over one video through a one-slot DecodeEngine:

        sess = predictor.chat(frames, video_uid="clip1", max_new_tokens=128)
        a1 = sess.ask("What happens in the video?")
        a2 = sess.ask("Why does she leave?")   # no re-encode, no re-prefill
        sess.close()
    """

    def __init__(
        self,
        predictor,
        frames: np.ndarray,
        wav: Optional[np.ndarray] = None,
        frame_seconds: Optional[np.ndarray] = None,
        video_uid: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
        capacity: Optional[int] = None,  # the whole conversation's token
        # budget; default: the first prompt's bucket + 2048
        kv_quant: Optional[str] = None,
        temperature: float = 0.0,
        top_k: int = 50,
        top_p: float = 1.0,
        seed: int = 0,
        suffix_bucket: int = 64,  # follow-up suffixes pad to a multiple
        on_tokens=None,
    ):
        self.p = predictor
        self.frames = frames
        self.wav = wav
        self.frame_seconds = frame_seconds
        self.video_uid = video_uid
        self.max_new_tokens = max_new_tokens or predictor.max_new_tokens
        self.capacity = capacity
        self.kv_quant = kv_quant
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.suffix_bucket = suffix_bucket
        self.on_tokens = on_tokens
        self.history: List[Tuple[str, str]] = []
        self.turn_tokens: List[List[int]] = []  # generated ids per turn
        self._key = ("chat", id(self))
        self._engine = None
        self._kv_len = 0  # committed cache length after the last turn
        self._tail: List[int] = []  # generated tokens not yet in the cache
        self._last_tok: Optional[int] = None
        self._turn = 0
        self._closed = False

    def _embed_ids(self, ids: np.ndarray) -> torch.Tensor:
        cfg = self.p.cfg
        t = torch.from_numpy(np.asarray(ids, np.int64)[None]).to(self.p.device)
        return lm_mod.embed_tokens(cfg.lm, self.p.params["lm"], t, cfg.dtype, self.p.mesh)

    def _make_engine(self, first_len: int):
        from .batching import DecodeEngine

        cap = self.capacity or int(np.ceil((first_len + 2048) / 128) * 128)
        if cap < first_len + self.max_new_tokens:
            raise ValueError(f"session capacity {cap} cannot hold the first prompt ({first_len}) "
                             f"plus max_new_tokens ({self.max_new_tokens})")
        self.capacity = cap
        self._engine = DecodeEngine(
            self.p.cfg, self.p.params, num_slots=1, capacity=cap, attn_impl=self.p.attn_impl,
            kv_quant=self.kv_quant or self.p.kv_quant, act_quant=self.p.act_quant,
            on_tokens=self.on_tokens, mesh=self.p.mesh, device=self.p.device,
        )

    def _run(self) -> Any:
        (r,) = self._engine.run()
        if r.cancelled or r.timed_out:
            raise RuntimeError(f"session turn did not finish: {r!r}")
        return r

    def ask(self, question: str, max_new_tokens: Optional[int] = None) -> str:
        """Answer a question in this conversation.  Turn 1 packs and
        prefills the whole prompt; later turns extend the resident KV with
        only [uncommitted tail + template glue + question]."""
        from ..eval.runner import _trim_generated
        from .batching import Request

        if self._closed:
            raise RuntimeError("session is closed")
        cfg = self.p.cfg
        mnt = max_new_tokens or self.max_new_tokens
        self._turn += 1
        sampling = dict(temperature=self.temperature, top_k=self.top_k, top_p=self.top_p,
                        seed=self.seed + self._turn - 1)
        if self._turn == 1:
            embeds, amask, _ids = self.p.pack_prompt(
                self.frames, question, wav=self.wav, frame_seconds=self.frame_seconds,
                video_uid=self.video_uid)
            mask = amask.cpu().numpy()
            valid = int(mask.sum())
            self._make_engine(embeds.shape[1])
            req = Request(embeds=embeds, attn_mask=mask, max_new_tokens=mnt, uid=("turn", 1),
                          keep_prefix=self._key, **sampling)
        else:
            closed = self._last_tok in cfg.lm.eos_token_ids
            new_ids = encode_plain(self.p.tok, follow_up_text(cfg, question, closed))
            suffix = list(self._tail) + list(new_ids)
            Sb = int(np.ceil(len(suffix) / self.suffix_bucket) * self.suffix_bucket)
            padded = np.full((Sb,), cfg.lm.pad_token_id, np.int64)
            padded[: len(suffix)] = suffix
            se = self._embed_ids(padded)  # [1, Sb, H]
            L2 = self._kv_len + Sb
            if L2 + mnt > self.capacity:
                raise ValueError(f"conversation ({L2} tokens) + max_new_tokens ({mnt}) exceeds "
                                 f"session capacity {self.capacity}; open the session with a "
                                 "larger `capacity`")
            # the prefix rows come from the donor: only the suffix's embeds are read
            full = se.new_zeros((1, L2, se.shape[-1]))
            full[:, self._kv_len:] = se
            valid = self._kv_len + len(suffix)
            mask = (np.arange(L2) < valid)[None]
            req = Request(embeds=full, attn_mask=mask, max_new_tokens=mnt,
                          uid=("turn", self._turn), prefix_key=self._key,
                          prefix_len=self._kv_len, keep_prefix=self._key, **sampling)
        self._engine.submit(req)
        r = self._run()
        # committed generated tokens = kv_len - the request's valid length;
        # the rest (usually the final or EOS token) is fed next turn
        committed = r.kv_len - valid
        assert 0 <= committed <= len(r.tokens), (r.kv_len, valid, len(r.tokens))
        self._tail = [int(t) for t in r.tokens[committed:]]
        self._kv_len = r.kv_len
        self._last_tok = int(r.tokens[-1])
        self.turn_tokens.append([int(t) for t in r.tokens])
        text = self.p.tok.decode(_trim_generated(r.tokens, cfg.lm)).strip()
        self.history.append((question, text))
        return text

    def close(self):
        """Release the resident KV donor."""
        if self._engine is not None:
            self._engine.release_prefix(self._key)
        self._closed = True
