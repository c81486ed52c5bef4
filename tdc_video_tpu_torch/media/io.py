"""Python surface of the native media decoder (port of
tdc_video_tpu/media/io.py; the library is built from this package's own
copy of decoder.cc by media/build.py).

``decode_video(path, fps=1)`` samples frames by timestamp, as the
reference's decord reader and frame-index sampling do; ``load_audio(path)``
gives mono 16 kHz PCM, as its soundfile/librosa chain does.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from ..constants import AUDIO_SAMPLE_RATE

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from .build import build

    lib = ctypes.CDLL(build())
    lib.tdc_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.tdc_probe.restype = ctypes.c_int
    lib.tdc_decode_video.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.tdc_decode_video.restype = ctypes.c_int
    lib.tdc_decode_video_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.tdc_decode_video_mt.restype = ctypes.c_int
    lib.tdc_decode_video_range.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.tdc_decode_video_range.restype = ctypes.c_int
    lib.tdc_decode_audio.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.tdc_decode_audio.restype = ctypes.c_long
    lib.tdc_encode_test_video.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int,
    ]
    lib.tdc_encode_test_video.restype = ctypes.c_int
    _lib = lib
    return lib


def decoder():
    """The native library, built at first use.  Raises when it cannot be
    built or loaded (no g++, no FFmpeg libraries): callers that skip
    unreadable videos call this first, so that a missing decoder is not
    read as a missing video."""
    return _load()


def probe(path: str) -> dict:
    lib = _load()
    dur = ctypes.c_double()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ha = ctypes.c_int()
    rc = lib.tdc_probe(path.encode(), dur, fps, w, h, ha)
    if rc != 0:
        raise IOError(f"cannot probe {path} (rc={rc})")
    return {
        "duration": dur.value,
        "fps": fps.value,
        "width": w.value,
        "height": h.value,
        "has_audio": bool(ha.value),
    }


def decode_video(
    path: str,
    fps: float = 1.0,
    max_dim: int = 384,
    max_frames: int = 1000,
    threads: Optional[int] = None,
    fast: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (frames uint8 [N, H, W, 3], timestamps float64 [N]) sampled at
    `fps`, longer side scaled to max_dim (pad-to-square happens in
    data/images.py).

    threads > 1 runs the segment-parallel seek decoder (one worker per time
    slice — replaces decord's threaded decode, reference train.py:588-594);
    default from $TDC_DECODE_THREADS, else the host CPU count.  `fast`
    (or $TDC_DECODE_FAST=1) skips the codec loop filter — a decode speedup
    with sub-visual pixel drift, off by default for reference parity.
    Falls back to the sequential decoder when the container cannot be
    time-sliced (no duration / no timestamps)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = _load()
    ow = ctypes.c_int()
    oh = ctypes.c_int()
    # worst case: every row max_dim x max_dim
    buf = np.empty((max_frames, max_dim, max_dim, 3), np.uint8)
    ts = np.empty((max_frames,), np.float64)

    if threads is None:
        threads = int(os.environ.get("TDC_DECODE_THREADS", os.cpu_count() or 1))
    fast = fast or os.environ.get("TDC_DECODE_FAST", "") == "1"
    flags = 1 if fast else 0

    n = -1
    if threads > 1 or flags:
        n = lib.tdc_decode_video_mt(
            path.encode(),
            float(fps),
            int(max_dim),
            int(max_frames),
            int(threads),
            flags,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ow,
            oh,
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    if n < 0:  # single-thread path, or mt fallback (rc -7/-8/-9: unsliceable)
        n = lib.tdc_decode_video(
            path.encode(),
            float(fps),
            int(max_dim),
            int(max_frames),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ow,
            oh,
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    if n < 0:
        raise IOError(f"decode failed for {path} (rc={n})")
    w, h = ow.value, oh.value
    flat = buf.reshape(-1)[: n * h * w * 3]
    return flat.reshape(n, h, w, 3).copy(), ts[:n].copy()


def load_audio(
    path: str,
    rate: int = AUDIO_SAMPLE_RATE,
    max_seconds: float = 3600.0,
) -> Optional[np.ndarray]:
    """Mono float32 PCM at `rate`; None when the file has no audio stream."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = _load()
    max_samples = int(rate * max_seconds)
    buf = np.empty((max_samples,), np.float32)
    n = lib.tdc_decode_audio(
        path.encode(), int(rate), max_samples, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    )
    if n < 0:
        raise IOError(f"audio decode failed for {path} (rc={n})")
    if n == 0:
        return None
    return buf[:n].copy()


def decode_video_range(
    path: str,
    k0: int,
    k1: int,
    fps: float = 1.0,
    max_dim: int = 384,
    fast: bool = False,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode only sample targets [k0, k1) at `fps` (streaming chunk decode).
    Returns None when the container cannot be time-sliced (caller falls back
    to full-clip decode)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    lib = _load()
    ow = ctypes.c_int()
    oh = ctypes.c_int()
    n_range = max(0, k1 - k0)
    buf = np.empty((n_range, max_dim, max_dim, 3), np.uint8)
    ts = np.empty((max(1, n_range),), np.float64)
    n = lib.tdc_decode_video_range(
        path.encode(),
        float(fps),
        int(max_dim),
        int(k0),
        int(k1),
        1 if fast else 0,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ow,
        oh,
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if n in (-7, -8, -9):
        return None
    if n < 0:
        raise IOError(f"range decode failed for {path} (rc={n})")
    w, h = ow.value, oh.value
    flat = buf.reshape(-1)[: n * h * w * 3]
    return flat.reshape(n, h, w, 3).copy(), ts[:n].copy()


def encode_test_video(path: str, w: int = 160, h: int = 120, fps: float = 25.0, n_frames: int = 100) -> None:
    """Synthesize a real, seekable MPEG-4 fixture video (frame k is flat
    RGB(k%256, 3k%256, 64)) — test/bench infrastructure; this environment has
    no ffmpeg binary and GIFs cannot exercise the seek path."""
    lib = _load()
    rc = lib.tdc_encode_test_video(path.encode(), int(w), int(h), float(fps), int(n_frames))
    if rc != 0:
        raise IOError(f"test-video encode failed (rc={rc})")


def window_audio(wav: np.ndarray, window_seconds: int = 10, rate: int = AUDIO_SAMPLE_RATE):
    """Split to fixed 10-s windows + masks (the shape encode_audio expects;
    reference windows at cambrian_arch.py:1552-1560)."""
    win = window_seconds * rate
    n_win = max(1, -(-len(wav) // win))
    padded = np.zeros((n_win * win,), np.float32)
    padded[: len(wav)] = wav
    mask = np.zeros((n_win * win,), bool)
    mask[: len(wav)] = True
    return padded.reshape(n_win, win), mask.reshape(n_win, win)
