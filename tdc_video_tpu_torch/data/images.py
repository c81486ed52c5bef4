"""Frame preprocessing (port of tdc_video_tpu/data/images.py): the host
path and the device path.

The host path (expand2square, _resize_bicubic, preprocess_frame,
process_frames) is the JAX package's default: pad to square with the tower
mean, PIL's bicubic resize of 8-bit RGB, normalise.  PIL is not imported:
`pil_bicubic_resize` computes what Pillow's Image.resize(..., BICUBIC) does
(libImaging/Resample.c), bit for bit: Keys cubic with a = -0.5 widened by
the scale when downsampling, coefficients in 22-bit fixed point, the
horizontal pass rounded to uint8 before the vertical pass.

device_preprocess is the JAX package's on-device path: expand2square with
the tower mean as fill, then jax.image.resize(method="cubic",
antialias=True), then normalisation.  That resize is Keys cubic with
a = -0.5 and, when downsampling, the kernel widened by the scale factor; it
is not torch's bicubic (a = -0.75, no widening).  The separable resize
matrices are built here in numpy to the same definition and applied as two
matmuls.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..config import TDCConfig
from ..utils.profiling import span


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


def expand2square(img: np.ndarray, fill: Tuple[int, int, int]) -> np.ndarray:
    """uint8 [H, W, 3] -> centred square canvas filled with the tower mean."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    canvas = np.empty((side, side, 3), img.dtype)
    canvas[:] = np.asarray(fill, img.dtype)
    top = (side - h) // 2
    left = (side - w) // 2
    canvas[top: top + h, left: left + w] = img
    return canvas


# Pillow's fixed-point precision of the 8-bit resampling path
_PRECISION_BITS = 32 - 8 - 2


def _pil_bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), in float64 and its order of
    operations."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


@lru_cache(maxsize=32)
def _pil_coeffs(n_in: int, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis:
    (tap indices [n_out, K] into the input, int32 fixed-point weights
    [n_out, K]); taps past a row's window have weight 0."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((n_out, ksize), np.int64)
    kk = np.zeros((n_out, ksize), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), n_in) - xmin
        taps = np.arange(xmax)
        w = _pil_bicubic_filter(((taps + xmin) - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in w:  # Pillow's running sum, in its order
            ww += v
        if ww != 0.0:
            w = w / ww
        idx[xx, :xmax] = taps + xmin
        kk[xx, :xmax] = w
    fixed = np.trunc(np.where(kk < 0, -0.5 + kk * (1 << _PRECISION_BITS),
                              0.5 + kk * (1 << _PRECISION_BITS))).astype(np.int32)
    return idx, fixed


def _pil_pass(img: np.ndarray, n_out: int) -> np.ndarray:
    """One 8-bit resampling pass of Pillow along the rows (axis 0) of a
    uint8 [H, W, C] image: int32 sums from 1 << 21 (Pillow's, which do not
    overflow), shifted right by 22 and clipped to 0..255.  One tap at a
    time over all outputs, each a gather of whole rows."""
    idx, k = _pil_coeffs(img.shape[0], n_out)
    rows = img.reshape(img.shape[0], -1)
    acc = np.full((n_out, rows.shape[1]), 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(idx.shape[1]):
        acc += rows[idx[:, t]] * k[:, t, None]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8).reshape((n_out,) + img.shape[1:])


def pil_bicubic_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """PIL's Image.fromarray(img).resize((width, height), Image.BICUBIC) for
    a uint8 [H, W, 3] image, without PIL: the horizontal pass first (on the
    transposed image, so both passes gather rows), its result stored as
    uint8, then the vertical pass; an axis whose size does not change is not
    resampled."""
    out = img
    if width != img.shape[1]:
        out = _pil_pass(np.ascontiguousarray(out.transpose(1, 0, 2)), width).transpose(1, 0, 2)
    if height != img.shape[0]:
        out = _pil_pass(np.ascontiguousarray(out), height)
    return np.ascontiguousarray(out)


def _resize_bicubic(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return pil_bicubic_resize(img, size, size)


def preprocess_frame(img: np.ndarray, tp: TowerPreprocess) -> np.ndarray:
    """uint8 [H, W, 3] -> normalized float32 [size, size, 3]."""
    fill = tuple(int(m * 255) for m in tp.mean)
    sq = expand2square(img, fill)
    sq = _resize_bicubic(sq, tp.size)
    x = sq.astype(np.float32) / 255.0
    return (x - np.asarray(tp.mean, np.float32)) / np.asarray(tp.std, np.float32)


def process_frames(frames: Sequence[np.ndarray], cfg: TDCConfig) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 frames -> (siglip_px [T, 384, 384, 3], dino_px [T, 378, 378, 3]),
    on the host."""
    sig_tp, dino_tp = tower_preprocess_list(cfg)
    sig = np.stack([preprocess_frame(f, sig_tp) for f in frames])
    dino = np.stack([preprocess_frame(f, dino_tp) for f in frames])
    return sig, dino


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
def cubic_resize_matrix(n_in: int, n_out: int, antialias: bool = True) -> np.ndarray:
    """[n_out, n_in] weights of jax.image.resize(method="cubic", antialias)
    along one axis: half-pixel centres, the Keys kernel (widened by 1/scale
    when downsampling if antialias), columns normalised, samples outside the
    input zeroed."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = np.float32(max(inv_scale, 1.0) if antialias else 1.0)
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
    with span("encode.preprocess", device=True, frames=frames_u8.shape[0]):
        return _device_preprocess(frames_u8, cfg)


def _device_preprocess(frames_u8: torch.Tensor, cfg: TDCConfig):
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
