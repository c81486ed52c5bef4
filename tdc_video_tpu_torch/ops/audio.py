"""Audio front end: Kaldi log-mel filterbanks and the audio/frame alignment
(port of tdc_video_tpu/ops/audio.py).

The fbank is the JAX chain op for op: framing by a gather (400-sample
windows, shift 160, snip_edges), DC removal, pre-emphasis 0.97, the Povey
window, zero padding to 512, `torch.fft.rfft`, the power spectrum, one
[257 x 128] mel matmul and log(max(mel, EPSILON)).  It always runs in f32,
as the reference pins BEATs' preprocessing to full precision.  The numpy
helpers (window, mel banks, frame count, `second_groups`) are copies of the
JAX package's, bit for bit.

`pool_seconds_to_frames` is JAX's one scatter-add written as a gather: each
(frame, bin) cell reads its contributions in the order JAX's scatter adds
them (ascending source row) from a table the host builds from the small
integer inputs, and sums them in that order in f32.  CUDA's atomic scatter-add (`index_add_`,
`index_put_(accumulate=True)`) would add in a different order on every run;
the gather gives the same bits on every run.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..constants import AUDIO_SAMPLE_RATE, AUDIO_TOKENS_PER_SECOND, AUDIO_WINDOW_SECONDS
from .pooling import adaptive_avg_pool_tokens

# Kaldi fbank constants for 16 kHz / 25 ms / 10 ms (the torchaudio
# compliance defaults of the reference call)
WINDOW_SIZE = 400
WINDOW_SHIFT = 160
PADDED_WINDOW = 512  # round_to_power_of_two
NUM_MEL_BINS = 128
LOW_FREQ = 20.0
PREEMPHASIS = 0.97
EPSILON = 1.1920928955078125e-07  # kaldi float epsilon


def num_fbank_frames(n_samples: int) -> int:
    """snip_edges=True frame count."""
    if n_samples < WINDOW_SIZE:
        return 0
    return 1 + (n_samples - WINDOW_SIZE) // WINDOW_SHIFT


@functools.lru_cache(maxsize=4)
def _povey_window() -> np.ndarray:
    n = np.arange(WINDOW_SIZE, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (WINDOW_SIZE - 1))
    return (hann**0.85).astype(np.float32)


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=4)
def mel_banks(sample_rate: int = AUDIO_SAMPLE_RATE) -> np.ndarray:
    """[PADDED_WINDOW//2 + 1, NUM_MEL_BINS] triangular mel weights (kaldi
    get_mel_banks; high_freq = nyquist, low_freq = 20 Hz)."""
    num_fft_bins = PADDED_WINDOW // 2
    nyquist = 0.5 * sample_rate
    mel_low = _mel(LOW_FREQ)
    mel_high = _mel(nyquist)
    delta = (mel_high - mel_low) / (NUM_MEL_BINS + 1)
    fft_bin_width = sample_rate / PADDED_WINDOW
    mel_of_bin = _mel(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))

    left = mel_low + np.arange(NUM_MEL_BINS)[:, None] * delta
    center = left + delta
    right = center + delta
    up = (mel_of_bin[None, :] - left) / delta
    down = (right - mel_of_bin[None, :]) / delta
    weights = np.maximum(0.0, np.minimum(up, down))  # [128, 256]
    out = np.zeros((NUM_MEL_BINS, num_fft_bins + 1), np.float32)
    out[:, :num_fft_bins] = weights
    return out.T.copy()  # [257, 128]


def kaldi_fbank(wav: torch.Tensor) -> torch.Tensor:
    """[B, N] waveform in [-1, 1] -> [B, frames, 128] f32 log-mel, as
    torchaudio.compliance.kaldi.fbank with the reference's arguments (dither
    0, remove_dc_offset, preemphasis 0.97, povey window, use_power,
    use_log_fbank) and its 2**15 input scaling."""
    wav = wav.float() * 32768.0
    B, N = wav.shape
    F = num_fbank_frames(N)
    frames = wav[:, : (F - 1) * WINDOW_SHIFT + WINDOW_SIZE].unfold(1, WINDOW_SIZE, WINDOW_SHIFT)

    frames = frames - frames.mean(dim=-1, keepdim=True)  # remove_dc_offset
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - PREEMPHASIS * prev
    frames = frames * torch.from_numpy(_povey_window()).to(wav.device)

    frames = torch.nn.functional.pad(frames, (0, PADDED_WINDOW - WINDOW_SIZE))
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real**2 + spec.imag**2  # [B, F, 257]
    mel = power @ torch.from_numpy(mel_banks()).to(wav.device)  # [B, F, 128]
    return torch.log(torch.clamp(mel, min=EPSILON))


def normalize_fbank(fbank: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """BEATs input normalisation: (x - mean) / (2 * std)."""
    return (fbank - mean) / (2.0 * std)


def window_to_seconds(tokens: torch.Tensor, seconds: int = AUDIO_WINDOW_SECONDS) -> torch.Tensor:
    """[B, Twin, C] BEATs tokens of one `seconds`-long window -> [B, seconds,
    50, C].  Second s is tokens [50 s, 50 s + 50); a short last slice is
    adaptive-average-pooled up to 50 (a 10-s window gives 496 tokens, so
    second 9 holds 46), an empty one is zeros."""
    B, _, C = tokens.shape
    per = AUDIO_TOKENS_PER_SECOND
    out = []
    for s in range(seconds):
        sl = tokens[:, s * per: (s + 1) * per]
        if sl.shape[1] == 0:
            sl = tokens.new_zeros((B, per, C))
        elif sl.shape[1] != per:
            sl = adaptive_avg_pool_tokens(sl, per)
        out.append(sl)
    return torch.stack(out, dim=1)


def second_groups(sample_indices: np.ndarray):
    """Host side: per-second (frame_id, group_pos) and per-frame group_size.

    `sample_indices` is the keep bitmap over source seconds (1 = this
    second's frame survived resampling).  A kept frame's audio group is its
    own second plus the dropped seconds after it; leading dropped seconds
    pool into frame 0."""
    s = np.asarray(sample_indices).astype(np.int64)
    S = s.shape[0]
    frame_of_sec = np.maximum(np.cumsum(s) - 1, 0)
    T = int(s.sum()) if s.sum() > 0 else 1
    group_size = np.bincount(frame_of_sec, minlength=T).astype(np.int32)
    group_pos = np.zeros(S, np.int32)
    run = {}
    for i in range(S):
        f = frame_of_sec[i]
        group_pos[i] = run.get(f, 0)
        run[f] = group_pos[i] + 1
    return frame_of_sec.astype(np.int32), group_pos, group_size


def pool_seconds_to_frames(
    per_sec: torch.Tensor,  # [S, 50, C] per-second audio tokens
    frame_of_sec: torch.Tensor,  # [S] output frame of each second
    group_pos: torch.Tensor,  # [S] position of the second within its group
    group_size: torch.Tensor,  # [T] seconds pooled into each frame
    num_frames: int,
    sec_valid: torch.Tensor = None,  # [S] bool
) -> torch.Tensor:
    """Returns [num_frames, 50, C]: adaptive_avg_pool over each frame's
    concatenated group.  A group of g seconds concatenates to 50 g rows and
    pools to 50 bins of g rows, so row (p * 50 + r) lands in bin
    (p * 50 + r) // g with weight 1 / g; invalid seconds add nothing."""
    S, per, C = per_sec.shape
    dev = per_sec.device
    f, p, gs = (x.cpu().numpy().astype(np.int64) for x in (frame_of_sec, group_pos, group_size))
    valid = np.ones(S, bool) if sec_valid is None else sec_valid.cpu().numpy().astype(bool)
    g = np.maximum(gs[np.clip(f, 0, num_frames - 1)], 1)  # [S]
    bin_idx = np.clip((p[:, None] * per + np.arange(per)) // g[:, None], 0, per - 1)
    w = torch.from_numpy(np.where(valid, 1.0 / g, 0.0).astype(np.float32)).to(dev)
    contrib = (per_sec.float() * w[:, None, None]).reshape(S * per, C)

    # on the host: the source rows of each (frame, bin) cell in ascending
    # order, padded with row S * per (zeros); invalid seconds and frames
    # past the end go nowhere, as JAX's trash frame and dropped indices
    D = num_frames * per
    keep = (valid & (f < num_frames))[:, None].repeat(per, 1)
    dest = (f[:, None] * per + bin_idx)[keep]
    order = np.flatnonzero(keep)[np.argsort(dest, kind="stable")]
    dest = np.sort(dest, kind="stable")
    rank = np.arange(len(dest)) - np.searchsorted(dest, dest)
    table = np.full((D, int(rank.max(initial=0)) + 1), S * per, np.int64)
    table[dest, rank] = order
    table = torch.from_numpy(table).to(dev)
    src = torch.cat([contrib, contrib.new_zeros((1, C))])
    out = contrib.new_zeros((D, C))
    for j in range(table.shape[1]):  # JAX's scatter order: one source of each cell at a time
        out = out + src[table[:, j]]
    return out.reshape(num_frames, per, C).to(per_sec.dtype)
