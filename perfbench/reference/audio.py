"""Plain PyTorch reference of the audio path: Kaldi log-mel filterbanks,
BEATs, and the pooling of each frame's seconds of audio tokens.

Written from the definitions: torchaudio's Kaldi fbank with the reference's
arguments (16 kHz, 25 ms windows every 10 ms, snip_edges, dither 0, DC
removal, pre-emphasis 0.97, the Povey window, a 512-point power spectrum,
128 mel bins from 20 Hz, log with Kaldi's epsilon, input scaled by 2**15);
BEATs (16x16 patches, post-norm encoder with deep-norm residuals, gated
relative position bias, T5 buckets); a second is 50 tokens, a frame pools
the seconds of its group.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .model import F32, Prec, layer, lin


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_matrix(bins: int = 128, n_fft: int = 512, rate: int = 16000, low: float = 20.0) -> np.ndarray:
    """[n_fft/2 + 1, bins] triangular filters, equally spaced in mel from
    `low` to Nyquist (the Nyquist bin unused)."""
    lo, hi = _mel(low), _mel(rate / 2)
    delta = (hi - lo) / (bins + 1)
    m = _mel(rate / n_fft * np.arange(n_fft // 2))
    left = lo + np.arange(bins)[:, None] * delta
    w = np.maximum(0.0, np.minimum((m - left) / delta, (left + 2 * delta - m) / delta))
    out = np.zeros((n_fft // 2 + 1, bins))
    out[:n_fft // 2] = w.T
    return out


def fbank(wav: torch.Tensor) -> torch.Tensor:
    """[B, N] waveform in [-1, 1] -> [B, frames, 128] float32 log-mel."""
    x = wav.double() * 32768.0
    frames = x.unfold(1, 400, 160)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[..., :1], frames[..., :-1]], -1)
    n = torch.arange(400, dtype=torch.float64, device=wav.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2 * math.pi * n / 399)) ** 0.85
    power = torch.fft.rfft(F.pad(frames, (0, 112)), dim=-1).abs() ** 2
    mel = power @ torch.from_numpy(mel_matrix()).to(wav.device)
    return torch.log(mel.clamp_min(1.1920928955078125e-07)).float()


def t5_buckets(T: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[T, T] bidirectional relative-position buckets (key - query)."""
    rel = np.arange(T)[None, :] - np.arange(T)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    large = exact + (np.log(np.maximum(rel, 1) / exact) / math.log(max_distance / exact)
                     * (nb - exact)).astype(np.int64)
    return out + np.where(rel < exact, rel, np.minimum(large, nb - 1))


def beats(bc, p, fb: torch.Tensor, fb_valid: torch.Tensor, P: Prec = F32) -> torch.Tensor:
    """BEATs on log-mel [B, F, 128] (frames valid where fb_valid) ->
    [B, (F // 16) * 8, 768]."""
    B, Fr, M = fb.shape
    ps = bc.patch_size
    gt, gf = Fr // ps, M // ps
    x = ((fb - bc.fbank_mean) / (2 * bc.fbank_std)).to(P.dtype)
    x = x[:, :gt * ps].reshape(B, gt, ps, gf, ps).permute(0, 1, 3, 2, 4).reshape(B, gt * gf, ps * ps)
    x = x @ P.w(p["patch_embed"]["w"])
    if "b" in p["patch_embed"]:
        x = x + P.v(p["patch_embed"]["b"])
    x = F.layer_norm(x.float(), x.shape[-1:], p["patch_norm"]["scale"].float(),
                     p["patch_norm"]["bias"].float(), 1e-5).to(P.dtype)
    x = lin(p["post_extract_proj"], x, P)
    T = x.shape[1]
    valid = fb_valid[:, :gt * ps].reshape(B, gt, ps).any(-1).repeat_interleave(gf, 1)
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    conv = F.conv1d(x.transpose(1, 2), P.v(p["pos_conv"]["w"]), padding=64, groups=16)
    x = x + F.gelu(conv.transpose(1, 2)[:, :-1] + P.v(p["pos_conv"]["b"]))
    ln = lambda q, y: F.layer_norm(y.float(), y.shape[-1:], q["scale"].float(),  # noqa: E731
                                   q["bias"].float(), 1e-5).to(P.dtype)
    x = ln(p["encoder_norm"], x)
    buckets = torch.from_numpy(t5_buckets(T, bc.num_buckets, bc.max_distance)).to(x.device)
    pos = p["rel_pos_bias"].float()[buckets].permute(2, 0, 1)  # [H, T, T]
    alpha = (2.0 * bc.num_layers) ** 0.25 if bc.deep_norm else 1.0
    nh = bc.num_heads
    hd = x.shape[-1] // nh
    for i in range(bc.num_layers):
        lp = layer(p["layers"], i)
        q, k, v = (lin(lp[n], x, P).reshape(B, T, nh, hd) for n in ("q_proj", "k_proj", "v_proj"))
        s = (q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1)).float() * hd ** -0.5
        g = torch.sigmoid(lin(lp["grep_linear"], q.float(), F32).reshape(B, T, nh, 2, 4).sum(-1))
        gate = g[..., 0] * (g[..., 1] * lp["grep_a"].float() - 1.0) + 2.0  # [B, T, H]
        s = s + gate.transpose(1, 2)[..., None] * pos[None]
        s = s.masked_fill(~valid[:, None, None, :], -1e30)
        a = (torch.softmax(s, -1).to(v.dtype) @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        x = ln(lp["attn_norm"], x * alpha + lin(lp["o_proj"], a.reshape(B, T, -1), P))
        h = lin(lp["fc2"], F.gelu(lin(lp["fc1"], x, P)), P)
        x = ln(lp["final_norm"], x * alpha + h)
    return x


def per_second(tokens: torch.Tensor, seconds: int = 10, per: int = 50) -> torch.Tensor:
    """[W, Tw, C] tokens of 10-s windows -> [W * seconds, per, C]: second s
    is tokens [per s, per (s + 1)), a short last slice averaged up to `per`
    (bin i over rows floor(i n / per) .. ceil((i + 1) n / per))."""
    W, Tw, C = tokens.shape
    out = []
    for s in range(seconds):
        sl = tokens[:, s * per:(s + 1) * per]
        n = sl.shape[1]
        if n == 0:
            sl = tokens.new_zeros((W, per, C))
        elif n != per:
            sl = torch.stack([sl[:, (i * n) // per: -(-((i + 1) * n) // per)].mean(1)
                              for i in range(per)], 1)
        out.append(sl)
    return torch.stack(out, 1).reshape(W * seconds, per, C)


def pool_frames(sec_tokens: torch.Tensor, frame_of_sec, group_pos, group_size, sec_valid,
                n_frames: int) -> torch.Tensor:
    """[S, 50, C] -> [n_frames, 50, C]: each frame's group of g seconds, in
    group order, concatenated to 50 g rows and averaged in runs of g (a
    second past the audio adds zeros but still counts)."""
    S, per, C = sec_tokens.shape
    f = [int(v) for v in frame_of_sec]
    pos = [int(v) for v in group_pos]
    out = []
    for t in range(n_frames):
        g = max(int(group_size[t]), 1)
        rows = sec_tokens.new_zeros((g * per, C))
        for s in range(S):
            if f[s] == t and bool(sec_valid[s]):
                rows[pos[s] * per:(pos[s] + 1) * per] = sec_tokens[s]
        out.append(rows.reshape(per, g, C).mean(1))
    return torch.stack(out)


def encode_audio(m, params, windows, wmask, frame_of_sec, group_pos, group_size, sec_valid,
                 n_frames: int, P: Prec = F32) -> torch.Tensor:
    """One sample's audio tokens [n_frames, 50, H] (through audio_proj)."""
    with torch.no_grad():
        fb = fbank(windows)
        tokens = beats(m.beats, params["beats"], fb, wmask[:, ::160][:, :fb.shape[1]], P)
    return lin(params["audio_proj"], pool_frames(per_second(tokens.float()), frame_of_sec, group_pos,
                                                 group_size, sec_valid, n_frames).to(P.dtype), P)
