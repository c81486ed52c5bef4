"""Supervised training dataset + fixed-shape collation (port of
tdc_video_tpu/train/dataset.py; host numpy, batches bitwise equal to JAX's).

LazySupervisedDataset + DataCollatorForSupervisedDataset of the reference
(tdc/train.py:425-814): lazy JSON rows; per-item video decode at 1 fps
(media/io, the native decoder) with .npy / image / frame-dir rows
(train.py:565-594; PIL imported where an image is read); uniform cap with
the sample_indices keep-bitmap (:414-423); pad-to-square per-tower
preprocessing (data/images.process_frames); optional audio; chat
tokenization with label masking; fall-back to item 0 on any load failure
(:544,600,603).  Length/modality-grouped batching mirrors
LengthGroupedSampler (mm_trainer.py:116-151).

Batches come out as fixed-shape numpy dicts, the Trainer's input: all
raggedness is resolved on the host.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..config import TDCConfig
from ..constants import IGNORE_INDEX
from ..data.images import pad_frames, process_frames
from ..data.preprocess import pack_text, preprocess
from ..ops.segment import uniform_sample_indices


def uniform_sample(frames: np.ndarray, max_frames: int):
    """Cap + keep-bitmap (reference uniform_sample, train.py:414-423)."""
    n = len(frames)
    if n <= max_frames:
        return frames, np.ones(n, np.int64)
    idx = uniform_sample_indices(n, max_frames)
    keep = np.zeros(n, np.int64)
    keep[idx] = 1
    return frames[idx], keep


@dataclass
class TrainSample:
    input_ids: List[int]
    labels: List[int]
    qformer_prompt: str
    frames: Optional[np.ndarray]  # uint8 [T, H, W, 3] or None (text-only)
    sample_indices: Optional[np.ndarray]
    audio_path: Optional[str]
    n_tokens: int
    has_video: bool


class SupervisedDataset:
    def __init__(
        self,
        data_path: str,
        cfg: TDCConfig,
        tokenizer,
        image_folder: str = "",
        audio_folder: str = "",
        video_fps: float = 1.0,
        max_frames: int = 224,
    ):
        with open(data_path) as fh:
            self.rows = json.load(fh)
        self.cfg = cfg
        self.tok = tokenizer
        self.image_folder = image_folder
        self.audio_folder = audio_folder
        self.video_fps = video_fps
        self.max_frames = max_frames

    def __len__(self) -> int:
        return len(self.rows)

    def lengths(self) -> List[int]:
        """Approximate token lengths for grouped batching
        (mm_trainer.py:226-243: +128 image-token bonus for multimodal rows)."""
        out = []
        for r in self.rows:
            n = sum(len(t.get("value", t.get("content", "")).split()) for t in r["conversations"])
            out.append(n + (128 if ("image" in r or "video" in r) else 0))
        return out

    def modality(self) -> List[bool]:
        return [("image" in r or "video" in r) for r in self.rows]

    def _load_visual(self, row) -> Optional[np.ndarray]:
        from ..media.io import decode_video

        if "video" in row:
            path = os.path.join(self.image_folder, row["video"])
            if path.endswith(".npy"):
                return np.load(path)[: self.max_frames * 4]
            if os.path.isdir(path):
                from PIL import Image
                import glob

                files = sorted(glob.glob(os.path.join(path, "*")))
                return np.stack(
                    [np.asarray(Image.open(f).convert("RGB")) for f in files]
                )
            frames, _ = decode_video(path, fps=self.video_fps, max_frames=1000)
            return frames
        if "image" in row:
            from PIL import Image

            img = np.asarray(
                Image.open(os.path.join(self.image_folder, row["image"])).convert("RGB")
            )
            return img[None]
        return None

    def __getitem__(self, i: int) -> TrainSample:
        try:
            return self._get(i)
        except Exception:
            # reference falls back to item 0 on any decode failure
            # (train.py:544,600,603)
            if i == 0:
                raise
            return self._get(0)

    def _get(self, i: int) -> TrainSample:
        row = self.rows[i]
        has_visual = "image" in row or "video" in row
        out = preprocess(
            [row["conversations"]],
            self.tok,
            conv_version=self.cfg.conv_version,
            has_image=has_visual,
        )
        frames = self._load_visual(row) if has_visual else None
        keep = None
        if frames is not None:
            frames, keep = uniform_sample(frames, self.max_frames)
        audio_path = None
        if "audio" in row:
            audio_path = os.path.join(self.audio_folder or self.image_folder, row["audio"])
        return TrainSample(
            input_ids=out["input_ids"][0],
            labels=out["labels"][0],
            qformer_prompt=out["prompts"][0] if out["prompts"] else "",
            frames=frames,
            sample_indices=keep,
            audio_path=audio_path,
            n_tokens=len(out["input_ids"][0]),
            has_video="video" in row,
        )


def modality_grouped_order(
    lengths: List[int], modality: List[bool], batch_size: int, seed: int = 0
) -> List[int]:
    """Length-grouped, modality-separated shuffle
    (mm_trainer.py:18-151 get_modality_length_grouped_indices)."""
    rng = random.Random(seed)
    mm = [i for i, m in enumerate(modality) if m]
    txt = [i for i, m in enumerate(modality) if not m]
    batches, leftovers = [], []
    for group in (mm, txt):
        order = sorted(group, key=lambda i: (lengths[i], rng.random()))
        # megabatch shuffle keeps similar lengths together but randomizes order
        mega = [order[i : i + batch_size * 50] for i in range(0, len(order), batch_size * 50)]
        rng.shuffle(mega)
        flat = [i for m_ in mega for i in m_]
        full = len(flat) - len(flat) % batch_size
        batches.extend(flat[i : i + batch_size] for i in range(0, full, batch_size))
        leftovers.extend(flat[full:])
    rng.shuffle(batches)
    batches.append(leftovers)  # ragged tail batch (may mix modalities)
    return [i for b in batches for i in b]


class Collator:
    """Fixed-shape batch assembly (replaces DataCollator, train.py:715-814)."""

    def __init__(
        self,
        cfg: TDCConfig,
        bert_tokenizer=None,
        max_len: int = 4096,
        max_frames: int = 64,
        qformer_text_len: int = 64,
        max_audio_windows: int = 8,  # 10-s windows per sample (80 s of audio)
    ):
        self.cfg = cfg
        self.bert_tok = bert_tokenizer
        self.max_len = max_len
        self.max_frames = max_frames
        self.qformer_text_len = qformer_text_len
        self.max_audio_windows = max_audio_windows

    def _audio_arrays(self, samples: List[TrainSample]):
        """Raw audio windows + alignment metadata for in-graph BEATs encode
        (reference audio path, cambrian_arch.py:1547-1598)."""
        from ..media.io import load_audio, window_audio
        from ..ops.audio import second_groups

        B, Ts, W = len(samples), self.max_frames, self.max_audio_windows
        win = np.zeros((B, W, 160000), np.float32)
        wmask = np.zeros((B, W, 160000), bool)
        S = W * 10
        f_of_s = np.zeros((B, S), np.int32)
        g_pos = np.zeros((B, S), np.int32)
        g_size = np.ones((B, Ts), np.int32)
        s_valid = np.zeros((B, S), bool)
        any_audio = False
        for b, s in enumerate(samples):
            if not s.audio_path or not os.path.exists(s.audio_path):
                continue
            wav = load_audio(s.audio_path)
            if wav is None:
                continue
            any_audio = True
            ws, ms = window_audio(wav)
            n = min(len(ws), W)
            win[b, :n], wmask[b, :n] = ws[:n], ms[:n]
            keep = (
                s.sample_indices[: S]
                if s.sample_indices is not None
                else np.ones(min(S, self.max_frames), np.int64)
            )
            kb = np.zeros(S, np.int64)
            kb[: len(keep)] = keep
            if kb.sum() == 0:
                kb[0] = 1
            f, p, g = second_groups(kb)
            f_of_s[b] = np.clip(f, 0, Ts - 1)
            g_pos[b] = p
            g_size[b, : min(len(g), Ts)] = g[:Ts]
            s_valid[b] = np.arange(S) < max(1, int(len(wav) / 16000))
        if not any_audio:
            return {}
        return {
            "audio_windows": win,
            "audio_wmask": wmask,
            "audio_frame_of_sec": f_of_s,
            "audio_group_pos": g_pos,
            "audio_group_size": g_size,
            "audio_sec_valid": s_valid,
        }

    def _qformer_ids(self, texts: List[str]):
        L = self.qformer_text_len
        if self.bert_tok is None:
            return np.zeros((len(texts), L), np.int32), np.zeros((len(texts), L), bool)
        enc = self.bert_tok(
            texts, padding="max_length", truncation=True, max_length=L
        )
        return (
            np.asarray(enc["input_ids"], np.int32),
            np.asarray(enc["attention_mask"], bool),
        )

    def __call__(self, samples: List[TrainSample]) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        packed = pack_text(
            [s.input_ids for s in samples],
            [s.labels for s in samples],
            max_len=self.max_len,
            pad_id=cfg.lm.pad_token_id,
        )
        B = len(samples)
        Ts = self.max_frames
        s_size, d_size = cfg.siglip.image_size, cfg.dino.image_size
        sig = np.zeros((B, Ts, s_size, s_size, 3), np.float32)
        dino = np.zeros((B, Ts, d_size, d_size, 3), np.float32)
        fmask = np.zeros((B, Ts), bool)
        from ..compress.aspect import frame_token_layout, square_layout

        tv0, qp0 = square_layout(cfg)
        token_valid = np.broadcast_to(tv0[None], (B,) + tv0.shape).copy()
        query_pool = np.broadcast_to(qp0[None], (B,) + qp0.shape).copy()
        for b, s in enumerate(samples):
            if s.frames is None:
                continue
            sg, dn = process_frames(list(s.frames), cfg)
            sg, dn, m = pad_frames(sg, dn, Ts)
            sig[b], dino[b], fmask[b] = sg, dn, m
            token_valid[b], query_pool[b] = frame_token_layout(
                cfg, s.frames.shape[1], s.frames.shape[2]
            )
        qids, qmask = self._qformer_ids([s.qformer_prompt for s in samples])
        audio = self._audio_arrays(samples) if self.cfg.audio_input else {}
        return {
            **audio,
            "input_ids": packed["input_ids"],
            "labels": packed["labels"],
            "image_pos": packed["image_pos"],
            "text_len": packed["text_len"],
            "has_image": packed["has_image"] & fmask.any(-1),
            "siglip_px": sig,
            "dino_px": dino,
            "frame_mask": fmask,
            "qformer_text_ids": qids,
            "qformer_text_mask": qmask,
            "token_valid": token_valid,
            "query_pool": query_pool,
        }


def data_iterator(
    dataset: SupervisedDataset,
    collator: Collator,
    batch_size: int,
    seed: int = 0,
    epochs: int = 1,
    group_by_modality_length: bool = True,
    start_step: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    for ep in range(epochs):
        if group_by_modality_length:
            order = modality_grouped_order(
                dataset.lengths(), dataset.modality(), batch_size, seed=seed + ep
            )
        else:
            order = list(range(len(dataset)))
            random.Random(seed + ep).shuffle(order)
        step = 0
        for i in range(0, len(order) - batch_size + 1, batch_size):
            if ep == 0 and step < start_step:
                step += 1
                continue
            yield collator([dataset[j] for j in order[i : i + batch_size]])
            step += 1
