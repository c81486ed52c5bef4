"""Streaming video ingestion: host decode overlaps device encode (port of
tdc_video_tpu/serving/streaming.py).

    [host thread]   decode + preprocess chunk t+1      (native decoder, PIL chain)
    [device]        towers + SVA encode of chunk t     (encode_frames)
    ...
    [device]        segmentation + TDC compression     (once, over all features)

Each chunk is copied to the device as it arrives and its encode is queued
behind the previous one; the host waits for the device once, after the last
chunk.  Chunks have one shape (`chunk_frames`; the last is padded and its
pad frames masked).  JAX's two jits are plain calls of model.encode_frames
and model.prepare_visual here.  With a mesh (parallel/mesh.py) each chunk's
frames split over its `data` axis: every rank encodes its contiguous share
and an all_gather over `data` gives every rank the chunk's features
(model.encode_frames); chunk_frames must divide by the axis.  Every rank
streams the same video.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..config import TDCConfig
from ..data.images import device_preprocess, process_frames
from ..device import resolve_device, synchronize
from ..model import encode_frames, prepare_visual


@dataclass
class StreamStats:
    decode_s: float = 0.0
    preprocess_s: float = 0.0
    encode_s: float = 0.0  # host time queueing the encodes (the device runs behind)
    compress_s: float = 0.0
    wall_s: float = 0.0
    frames: int = 0

    def summary(self) -> dict:
        vs = self.frames / self.wall_s if self.wall_s else 0.0
        return {
            "frames": self.frames,
            "wall_s": round(self.wall_s, 3),
            "video_sec_per_sec": round(vs, 2),
            "decode_s": round(self.decode_s, 3),
            "encode_s": round(self.encode_s, 3),
            "compress_s": round(self.compress_s, 3),
        }


def _emit_chunk(out_q, chunk, ts, chunk_frames, cfg, stats, device_prep):
    """Queue one chunk: raw uint8 padded to chunk_frames (device_prep), or
    preprocessed on the host and padded.  Items are (siglip or uint8, dino
    or None, valid frames, timestamps)."""
    n = len(chunk)
    if device_prep:
        if n < chunk_frames:
            chunk = np.concatenate([chunk, np.zeros((chunk_frames - n,) + chunk.shape[1:],
                                                    chunk.dtype)])
        out_q.put((chunk, None, n, ts[:n]))
        return
    t1 = time.perf_counter()
    sig, dino = process_frames(list(chunk), cfg)
    stats.preprocess_s += time.perf_counter() - t1
    if n < chunk_frames:
        pad = chunk_frames - n
        sig = np.concatenate([sig, np.zeros((pad,) + sig.shape[1:], sig.dtype)])
        dino = np.concatenate([dino, np.zeros((pad,) + dino.shape[1:], dino.dtype)])
    out_q.put((sig, dino, n, ts[:n]))


def _decode_chunks(video_path: str, fps: float, chunk_frames: int, max_frames: int,
                   out_q: queue.Queue, cfg: TDCConfig, stats: StreamStats, device_prep: bool):
    """Producer thread: decode -> (host preprocess | raw uint8) -> queue,
    then None; an exception is queued in place of the rest.

    Seekable containers decode chunk by chunk (media.io.decode_video_range),
    so chunk t+1 decodes while chunk t encodes; GIFs and other unsliceable
    containers fall back to one full decode."""
    from ..media import io as media_io

    try:
        k0 = 0
        while k0 < max_frames:
            k1 = min(k0 + chunk_frames, max_frames)
            t0 = time.perf_counter()
            out = media_io.decode_video_range(video_path, k0, k1, fps=fps)
            stats.decode_s += time.perf_counter() - t0
            if out is None:
                # unsliceable: decode it all and emit from the first target
                # not yet delivered (a refusal may come mid-stream)
                t0 = time.perf_counter()
                frames, ts = media_io.decode_video(video_path, fps=fps, max_frames=max_frames)
                stats.decode_s += time.perf_counter() - t0
                for start in range(k0, len(frames), chunk_frames):
                    _emit_chunk(out_q, frames[start:start + chunk_frames],
                                ts[start:start + chunk_frames], chunk_frames, cfg, stats,
                                device_prep)
                break
            chunk, ts = out
            if len(chunk) == 0:
                break
            _emit_chunk(out_q, chunk, ts, chunk_frames, cfg, stats, device_prep)
            if len(chunk) < k1 - k0:  # the end of the video inside this chunk
                break
            k0 = k1
        out_q.put(None)
    except Exception as e:  # handed to the consumer, which raises it
        out_q.put(e)


class StreamingEncoder:
    """Chunked encode with decode/compute overlap; compress at the end of
    the stream.  Runs on CUDA unless device="cpu"."""

    def __init__(self, cfg: TDCConfig, params: Any, chunk_frames: int = 32,
                 max_frames: int = 1000, prefetch: int = 2, device_prep: bool = True,
                 mesh: Optional[Any] = None, device=None):
        if mesh is not None and chunk_frames % mesh.size("data"):
            raise ValueError(f"chunk_frames {chunk_frames} does not divide by the mesh's data "
                             f"axis ({mesh.size('data')})")
        self.cfg = cfg
        self.params = params
        self.chunk_frames = chunk_frames
        self.max_frames = max_frames
        self.prefetch = prefetch
        self.device_prep = device_prep
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            # pinned, so that the copy is queued behind the encodes before
            # it instead of waiting for them
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _encode(self, sig: np.ndarray, dino: Optional[np.ndarray]):
        cfg = self.cfg
        if dino is None:  # raw uint8 frames
            sig, dino = device_preprocess(self._to_device(sig), cfg)
        else:
            sig, dino = self._to_device(sig), self._to_device(dino)
        return encode_frames(cfg, self.params, sig.to(cfg.dtype), dino.to(cfg.dtype),
                             attn_impl="flash", mesh=self.mesh)

    def encode_stream(self, video_path: str, fps: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray, StreamStats]:
        """Returns (frame_feats [T, P, H], dino_feats [T, Nd, Cd],
        frame_mask [T] (on the device), timestamps, stats), T padded to a
        whole number of chunks."""
        stats = StreamStats()
        t_wall = time.perf_counter()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        producer = threading.Thread(
            target=_decode_chunks,
            args=(video_path, fps or self.cfg.video_fps, self.chunk_frames, self.max_frames, q,
                  self.cfg, stats, self.device_prep),
            daemon=True,
        )
        producer.start()

        feats, dinos, counts, ts_list = [], [], [], []
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            if item is None:
                break
            sig, dino, n, ts = item
            t0 = time.perf_counter()
            ff, df = self._encode(sig, dino)
            feats.append(ff)
            dinos.append(df)
            counts.append(n)
            ts_list.append(ts)
            stats.encode_s += time.perf_counter() - t0
        producer.join()

        if not feats:
            raise IOError(f"no frames decoded from {video_path}")
        frame_feats = torch.cat(feats)
        dino_feats = torch.cat(dinos)
        synchronize(self.device)
        mask = np.zeros((frame_feats.shape[0],), bool)
        for i, n in enumerate(counts):
            mask[i * self.chunk_frames: i * self.chunk_frames + n] = True
        stats.frames = int(sum(counts))
        stats.wall_s = time.perf_counter() - t_wall
        return (frame_feats, dino_feats, torch.from_numpy(mask).to(self.device),
                np.concatenate(ts_list), stats)

    def compress(self, frame_feats: torch.Tensor, dino_feats: torch.Tensor,
                 frame_mask: torch.Tensor, qformer_text_ids: Optional[torch.Tensor] = None,
                 qformer_text_mask: Optional[torch.Tensor] = None, max_visual_len: int = 4096):
        """Segmentation + TDC compression of the whole stream: (visual
        [max_visual_len, H], n_visual, seconds); unconditioned without
        Q-Former text."""
        if qformer_text_ids is None:
            qformer_text_ids = torch.zeros((8,), dtype=torch.int64, device=self.device)
            qformer_text_mask = torch.zeros((8,), dtype=torch.bool, device=self.device)
        t0 = time.perf_counter()
        visual, n_visual = prepare_visual(self.cfg, self.params, frame_feats, dino_feats,
                                          frame_mask, qformer_text_ids, qformer_text_mask,
                                          max_visual_len=max_visual_len)
        synchronize(self.device)
        return visual, n_visual, time.perf_counter() - t0
