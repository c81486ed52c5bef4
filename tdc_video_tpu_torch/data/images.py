"""Frame preprocessing on the device (port of frame_bucket, pad_frames and
device_preprocess from tdc_video_tpu/data/images.py).

device_preprocess is the JAX package's on-device path: expand2square with
the tower mean as fill, then jax.image.resize(method="cubic",
antialias=True), then normalisation.  That resize is Keys cubic with
a = -0.5 and, when downsampling, the kernel widened by the scale factor; it
is not torch's bicubic (a = -0.75, no widening).  The separable resize
matrices are built here in numpy to the same definition and applied as two
matmuls.  (The PIL host path of the JAX package is not ported.)
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import TDCConfig


@dataclasses.dataclass(frozen=True)
class TowerPreprocess:
    size: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]


SIGLIP_PREPROCESS = TowerPreprocess(384, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
DINOV2_PREPROCESS = TowerPreprocess(378, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def tower_preprocess_list(cfg: TDCConfig) -> List[TowerPreprocess]:
    return [
        dataclasses.replace(SIGLIP_PREPROCESS, size=cfg.siglip.image_size),
        dataclasses.replace(DINOV2_PREPROCESS, size=cfg.dino.image_size),
    ]


def pad_frames(sig: np.ndarray, dino: np.ndarray, max_frames: int):
    """Right-pad the frame axis to a static bucket; returns (sig, dino, mask)."""
    T = sig.shape[0]
    if T > max_frames:
        sig, dino, T = sig[:max_frames], dino[:max_frames], max_frames
    mask = np.zeros((max_frames,), bool)
    mask[:T] = True
    out_s = np.zeros((max_frames,) + sig.shape[1:], sig.dtype)
    out_d = np.zeros((max_frames,) + dino.shape[1:], dino.dtype)
    out_s[:T] = sig
    out_d[:T] = dino
    return out_s, out_d, mask


def frame_bucket(n: int, buckets: Sequence[int] = (8, 16, 32, 64, 128, 224, 448, 1000)) -> int:
    """Static frame-count buckets (kept for parity with the JAX compile keys)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@lru_cache(maxsize=32)
def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of jax.image.resize(method="cubic",
    antialias=True) along one axis: half-pixel centres, the Keys kernel
    widened by 1/scale when downsampling, columns normalised, samples
    outside the input zeroed."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = _keys_cubic(x)  # [n_in, n_out]
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps, w / np.where(tot != 0, tot, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def device_preprocess(frames_u8: torch.Tensor, cfg: TDCConfig):
    """uint8 frames [T, h, w, 3] (on the target device) -> (siglip_px,
    dino_px) f32, normalized, channels-last."""
    T, h, w, _ = frames_u8.shape
    side = max(h, w)
    top, left = (side - h) // 2, (side - w) // 2
    dev = frames_u8.device
    outs = []
    for tp in tower_preprocess_list(cfg):
        mean255 = torch.tensor([int(m * 255) for m in tp.mean], dtype=torch.float32, device=dev)
        canvas = mean255.expand(T, side, side, 3).clone()
        canvas[:, top:top + h, left:left + w] = frames_u8.float()
        x = canvas
        if side != tp.size:
            wm = torch.from_numpy(cubic_resize_matrix(side, tp.size)).to(dev)
            x = torch.einsum("ih,thwc->tiwc", wm, x)
            x = torch.einsum("jw,tiwc->tijc", wm, x)
        x = x / 255.0
        mean = torch.tensor(tp.mean, dtype=torch.float32, device=dev)
        std = torch.tensor(tp.std, dtype=torch.float32, device=dev)
        outs.append((x - mean) / std)
    return outs[0], outs[1]
