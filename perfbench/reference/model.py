"""Plain PyTorch reference of TDC-Video inference, written from the model's
description and independent of the port: frames -> tower preprocessing ->
SigLIP and DINOv2 -> SVA -> newline -> scene cuts -> TDC compression with
the Q-Former -> splice into the prompt -> the decoder -> logits (the
decoder from its family's file, perfbench/lm/<model.lm.name>.py, which
builds on `lin`, `rms`, `rope`, `attend`, `layer` and `Prec` here).

It reads the same parameter tree the port serves (bf16, the benchmark makes
it from the seed) and widens each weight where it is used, so that the
port's model and this one fit on one card together.  Every product runs in
`Prec.dtype` (float32, TF32 off, for the reference; bfloat16 with fp8
weights for the control).  Towers run in blocks of frames and the decoder's
attention in blocks of query rows, to bound memory.

Nothing here imports jax or the port: sizes come from the configuration's
JSON (`cfg`, a nested SimpleNamespace made by `namespace`).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import core


def namespace(d):
    """A JSON dict as nested SimpleNamespaces (lists of numbers stay lists)."""
    if isinstance(d, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in d.items()})
    return d


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """w rounded to float8 e4m3 with one scale per output column ([d_in,
    d_out] weights), back in float32."""
    wf = w.float()
    scale = (wf.abs().amax(dim=0, keepdim=True) / 448.0).clamp_min(1e-12)
    return (wf / scale).to(torch.float8_e4m3fn).float() * scale


class Prec:
    """Compute precision: `dtype` of every product; `fp8` rounds every
    matrix weight to float8 first (the control)."""

    def __init__(self, dtype=torch.float32, fp8: bool = False):
        self.dtype, self.fp8 = dtype, fp8

    def w(self, t: torch.Tensor) -> torch.Tensor:
        return (fp8_round(t) if self.fp8 and t.dim() == 2 else t.float()).to(self.dtype)

    def v(self, t: torch.Tensor) -> torch.Tensor:
        """A vector or table (bias, norm, embedding): widened, never fp8."""
        return t.float().to(self.dtype)


F32 = Prec()


def layer(tree, i: int):
    """Layer i of a tree whose leaves are stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def lin(p, x, P: Prec):
    y = x.to(P.dtype) @ P.w(p["w"])
    if "b" in p:
        y = y + P.v(p["b"])
    return y


def ln(p, x, eps, P: Prec):
    y = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(), p["bias"].float(), eps)
    return y.to(P.dtype)


def rms(p, x, eps, P: Prec):
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * p["scale"].float()
    return y.to(P.dtype)


def attend(q, k, v, key_mask=None, causal_from: Optional[int] = None, block: int = 1024):
    """Softmax attention, q [B, T, Hq, D], k/v [B, S, Hkv, D] (Hq a multiple
    of Hkv), softmax in float32.  key_mask [B, S] bool keeps keys;
    causal_from=c lets query row i see keys j <= i + c.  Query rows go in
    blocks of `block`."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kk = k.permute(0, 2, 3, 1).repeat_interleave(g, dim=1)  # B Hq D S
    vv = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)  # B Hq S D
    out = []
    for t0 in range(0, T, block):
        qb = q[:, t0:t0 + block].permute(0, 2, 1, 3)  # B Hq t D
        s = (qb @ kk).float() / math.sqrt(D)
        keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
        if causal_from is not None:
            rows = torch.arange(t0, t0 + qb.shape[2], device=q.device)[:, None]
            keep = torch.arange(S, device=q.device)[None] <= rows + causal_from
        keep = keep[None, None]
        if key_mask is not None:
            keep = keep & key_mask[:, None, None, :]
        s = s.masked_fill(~keep, float("-inf"))
        out.append((torch.softmax(s, -1).to(vv.dtype) @ vv).permute(0, 2, 1, 3))
    return torch.cat(out, 1)


# --- preprocessing (pad to square with the tower mean, antialiased Keys cubic) --

TOWER_PRE = {"siglip": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
             "dino": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of an antialiased cubic resize (Keys, a = -0.5,
    half-pixel centres, the kernel widened by 1/scale when shrinking,
    columns normalised)."""
    scale = n_out / n_in
    kscale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kscale
    w = np.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                 np.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2, 0.0))
    w = w / w.sum(0, keepdims=True)
    w[:, (sample < -0.5) | (sample > n_in - 0.5)] = 0
    return w.T.astype(np.float32)


def preprocess(frames_u8: torch.Tensor, size: int, tower: str) -> torch.Tensor:
    """uint8 [T, h, w, 3] -> normalized float32 [T, size, size, 3]."""
    T, h, w, _ = frames_u8.shape
    mean, std = (torch.tensor(x, device=frames_u8.device) for x in TOWER_PRE[tower])
    side = max(h, w)
    fill = torch.tensor([float(int(m * 255)) for m in TOWER_PRE[tower][0]], device=frames_u8.device)
    x = fill.expand(T, side, side, 3).clone()
    top, left = (side - h) // 2, (side - w) // 2
    x[:, top:top + h, left:left + w] = frames_u8.float()
    if side != size:
        m = torch.from_numpy(cubic_matrix(side, size)).to(x.device)
        x = torch.einsum("ih,thwc->tiwc", m, x)
        x = torch.einsum("jw,tiwc->tijc", m, x)
    return (x / 255.0 - mean) / std


# --- towers ---------------------------------------------------------------

def linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of a bilinear (triangle, no antialias) resize."""
    sample = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(sample[None, :] - np.arange(n_in)[:, None]))
    w = w / w.sum(0, keepdims=True)
    return w.T.astype(np.float32)


def resize_grid(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    if src == dst:
        return x
    B, _, C = x.shape
    m = torch.from_numpy(linear_matrix(src, dst)).to(x.device)
    y = torch.einsum("ih,bhwc,jw->bijc", m, x.float().reshape(B, src, src, C), m)
    return y.reshape(B, dst * dst, C).to(x.dtype)


def vit(vc, p, px: torch.Tensor, P: Prec) -> torch.Tensor:
    """SigLIP or DINOv2 on normalized pixels [B, H, W, 3] -> [B, interp, C]."""
    B, H, W, _ = px.shape
    ps, g = vc.patch_size, vc.image_size // vc.patch_size
    x = px[:, :g * ps, :g * ps].reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
    x = lin(p["patch_embed"], x.reshape(B, g * g, ps * ps * 3), P)
    if vc.use_cls_token:
        x = torch.cat([P.v(p["cls_token"]).expand(B, 1, -1), x], 1)
    x = x + P.v(p["pos_embed"])[None]
    nh = vc.num_heads
    for i in range(vc.num_layers):
        lp = layer(p["layers"], i)
        N, D = x.shape[1], x.shape[2]
        h = ln(lp["norm1"], x, vc.layer_norm_eps, P)
        q, k, v = (lin(lp[n], h, P).reshape(B, N, nh, D // nh) for n in ("q_proj", "k_proj", "v_proj"))
        a = lin(lp["o_proj"], attend(q, k, v).reshape(B, N, D), P)
        x = x + (a * P.v(lp["ls1"]) if vc.layerscale else a)
        h = ln(lp["norm2"], x, vc.layer_norm_eps, P)
        if vc.use_swiglu:
            gt, up = lin(lp["mlp"]["gate_up"], h, P).chunk(2, dim=-1)
            m = lin(lp["mlp"]["down"], F.silu(gt) * up, P)
        else:
            m = lin(lp["mlp"]["fc2"], F.gelu(lin(lp["mlp"]["fc1"], h, P), approximate="tanh"), P)
        x = x + (m * P.v(lp["ls2"]) if vc.layerscale else m)
    x = ln(p["final_norm"], x, vc.layer_norm_eps, P)
    if vc.use_cls_token:
        x = x[:, 1:]
    return resize_grid(x, g, int(vc.interp_tokens ** 0.5))


# --- SVA (spatial vision aggregator) --------------------------------------

def _windows(x: torch.Tensor, q_side: int) -> torch.Tensor:
    B, N, D = x.shape
    side = int(N ** 0.5)
    rf = side // q_side
    x = x.reshape(B, q_side, rf, q_side, rf, D).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, q_side * q_side, rf * rf, D)


def sva(sc, p, tower_feats: List[torch.Tensor], P: Prec) -> torch.Tensor:
    """[B, 576, C_tower] per tower -> [B, image_token_len, H_lm]."""
    gelu = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    proj = [ln(a["norm"], lin(a["fc2"], gelu(lin(a["fc1"], f, P)), P), 1e-6, P)
            for a, f in zip(p["aux_projectors"], tower_feats)]
    B, D = proj[0].shape[0], sc.vision_hidden_size
    context = proj[0].mean(1, keepdim=True)
    nh = sc.num_heads
    outs = []
    for gi in range(sc.num_query_group):
        nq = sc.query_num_list[gi]
        side = int(nq ** 0.5)
        q = P.v(p["vision_query"][gi]).expand(B, nq, D)
        wins = [_windows(f, side) for f in proj]
        for lp in p["samplers"][gi]["layers"]:
            residual = q
            ctx = lin(lp["proj_context"], context, P).expand(B, nq, D)
            h = lin(lp["proj_in"], torch.cat([q, ctx], -1), P)
            qh = lin(lp["q_proj"]["lin"], ln(lp["q_proj"]["norm"], h, 1e-5, P), P)
            ks, vs = [], []
            for ti, w in enumerate(wins):
                pe = lp["pos_embed"][ti]
                wp = w + P.v(pe)[None, None] if pe is not None else w
                kv = lp["kv"][ti]
                ks.append(lin(kv["k_proj"]["lin"], ln(kv["k_proj"]["norm"], wp, 1e-5, P), P))
                vs.append(lin(kv["v_proj"]["lin"], ln(kv["v_proj"]["norm"], wp, 1e-5, P), P))
            k, v = torch.cat(ks, 2), torch.cat(vs, 2)  # [B, nq, S, D]
            S = k.shape[2]
            a = attend(qh.reshape(B * nq, 1, nh, D // nh), k.reshape(B * nq, S, nh, D // nh),
                       v.reshape(B * nq, S, nh, D // nh))
            a = lin(lp["o_proj"], a.reshape(B, nq, D), P)
            h = ln(lp["norm"], h + a, 1e-5, P)
            q = lin(lp["proj_out"]["fc2"], gelu(lin(lp["proj_out"]["fc1"], h, P)), P) + residual
        outs.append(resize_grid(q, side, int(sc.image_token_len ** 0.5)))
    x = torch.cat(outs, -1)
    mm = p["mm_projector"]
    return lin(mm["fc2"], gelu(lin(mm["fc1"], x, P)), P)


def encode_frames(cfg, params, frames_u8: torch.Tensor, P: Prec = F32, block: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 frames [T, h, w, 3] on the device -> (frame tokens [T, side*(side+1),
    H] with one newline a row, DINOv2 features [T, 576, C]), in blocks of
    frames."""
    ff, df = [], []
    for t0 in range(0, frames_u8.shape[0], block):
        fu = frames_u8[t0:t0 + block]
        sig = vit(cfg.siglip, params["siglip"], preprocess(fu, cfg.siglip.image_size, "siglip").to(P.dtype), P)
        dino = vit(cfg.dino, params["dino"], preprocess(fu, cfg.dino.image_size, "dino").to(P.dtype), P)
        feats = sva(cfg.sva, params["sva"], [sig, dino], P)
        B, _, H = feats.shape
        side = int(cfg.sva.image_token_len ** 0.5)
        nl = P.v(params["image_newline"]).expand(B, side, 1, H)
        ff.append(torch.cat([feats.reshape(B, side, side, H), nl], 2).reshape(B, side * (side + 1), H))
        df.append(dino.float())
    return torch.cat(ff), torch.cat(df)


# --- scene cuts -----------------------------------------------------------

def adjacent_similarity(dino: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of each frame's DINOv2 features to the next's [T-1]."""
    flat = dino.reshape(dino.shape[0], -1).double()
    n = flat.norm(dim=-1)
    return ((flat[:-1] * flat[1:]).sum(-1) / (n[:-1] * n[1:])).float()


def scene_cuts(sims: torch.Tensor, n_frames: int, max_segments: int) -> torch.Tensor:
    """Segment starts [T] bool: every frame when the video has at most
    max_segments + 1 frames, else frame 0 and the frames after the
    max_segments least similar pairs (ties to the earlier pair)."""
    start = torch.zeros(n_frames, dtype=torch.bool, device=sims.device)
    if n_frames <= max_segments + 1:
        return ~start
    order = torch.sort(-sims, descending=True, stable=True).indices[:max_segments]
    start[order + 1] = True
    start[0] = True
    return start


def cut_gap(sims: torch.Tensor, starts: torch.Tensor, max_segments: int) -> float:
    """How far a set of segment starts is from a valid choice under `sims`:
    0 when its cut pairs are max_segments pairs no more similar than any
    pair left uncut (so equal to scene_cuts up to ties), else by how much
    the most similar cut pair exceeds the least similar uncut one.  A
    short video must start a segment at every frame; inf otherwise."""
    T = starts.shape[0]
    if T <= max_segments + 1:
        return 0.0 if bool(starts.all()) else math.inf
    cut = starts[1:]
    if not bool(starts[0]) or int(cut.sum()) != max_segments:
        return math.inf
    return max(0.0, float(sims[cut].max() - sims[~cut].min()))


def chunks_of(starts: Sequence[bool], chunk_size: int) -> List[List[int]]:
    """Frame indices of each chunk: a chunk begins at every segment start and
    every chunk_size frames into a segment."""
    out: List[List[int]] = []
    pos = 0
    for t, s in enumerate(starts):
        pos = 0 if s else pos + 1
        if s or pos % chunk_size == 0:
            out.append([])
        out[-1].append(t)
    return out


# --- TDC compression ------------------------------------------------------

def visual_count(chunks: List[List[int]], static_tokens: int, K: int, max_visual: int) -> int:
    """How many visual tokens `compress` emits for these chunks, each frame
    keeping static_tokens valid tokens (visual and audio)."""
    per = [static_tokens + 1 + (len(ch) - 1) * (K + 1) for ch in chunks]
    excess = sum(per) - max_visual
    if excess > 0:
        drop = -(-excess // len(per))
        per = [max(p - drop, 0) for p in per]
    return min(sum(per), max_visual)


def token_layout(side: int, orig_h: int, orig_w: int, K: int) -> Tuple[np.ndarray, np.ndarray]:
    """(valid [P] bool, pool [K, P]) of a frame's side x (side+1) tokens: the
    rows (or columns) the square padding added are invalid, the newline of
    a kept row valid; `pool` averages the valid tokens in K runs."""
    cols = side + 1
    valid = np.zeros((side, cols), bool)
    if orig_w > orig_h:
        pad = (side - int(orig_h * side / orig_w)) // 2
        valid[pad:side - pad, :] = True
    elif orig_h > orig_w:
        pad = (side - int(orig_w * side / orig_h)) // 2
        valid[:, pad:side - pad] = True
        valid[:, side] = True
    else:
        valid[:] = True
    valid = valid.reshape(-1)
    idx = np.nonzero(valid)[0]
    pool = np.zeros((K, valid.size), np.float32)
    for i in range(K):
        a, b = i * len(idx) // K, -(-(i + 1) * len(idx) // K)
        pool[i, idx[a:b]] = 1.0 / (b - a)
    return valid, pool


def qformer(qc, p, query, text_ids, text_mask, enc, enc_mask, P: Prec):
    """BERT with cross-attention every `cross_attention_freq` layers:
    query [B, Q, 768], text_ids/text_mask [L], enc [B, S, E], enc_mask [B, S]
    -> the queries' outputs [B, Q, 768]."""
    B, Q, _ = query.shape
    emb = p["embeddings"]
    L = text_ids.shape[0]
    text = P.v(emb["word"])[text_ids.long()] + P.v(emb["position"])[:L]
    x = ln(emb["norm"], torch.cat([query.to(P.dtype), text[None].expand(B, L, -1)], 1), qc.layer_norm_eps, P)
    keys = torch.cat([torch.ones(Q, dtype=torch.bool, device=x.device), text_mask.bool()])[None].expand(B, -1)
    nh = qc.num_heads
    hd = qc.hidden_size // nh

    def block(ap, xq, kv, mask):
        q = lin(ap["q_proj"], xq, P).reshape(B, xq.shape[1], nh, hd)
        k = lin(ap["k_proj"], kv, P).reshape(B, kv.shape[1], nh, hd)
        v = lin(ap["v_proj"], kv, P).reshape(B, kv.shape[1], nh, hd)
        a = lin(ap["o_proj"], attend(q, k, v, mask).reshape(B, xq.shape[1], -1), P)
        return ln(ap["norm"], a + xq, qc.layer_norm_eps, P)

    def ffn(fp, h):
        return ln(fp["norm"], lin(fp["fc2"], F.gelu(lin(fp["fc1"], h, P)), P) + h, qc.layer_norm_eps, P)

    for lp in p["layers"]:
        x = block(lp["self_attn"], x, x, keys)
        qp, tp = x[:, :Q], x[:, Q:]
        if lp["cross_attn"] is not None:
            qp = block(lp["cross_attn"], qp, enc.to(P.dtype), enc_mask)
        x = torch.cat([ffn(lp["ffn_query"], qp), ffn(lp["ffn"], tp)], 1)
    return x[:, :Q]


def compress(cfg, p, frame_tokens: torch.Tensor, chunks: List[List[int]], valid: np.ndarray,
             pool: np.ndarray, max_visual: int, P: Prec = F32,
             text_ids=None, text_mask=None) -> torch.Tensor:
    """TDC: each chunk emits its first frame's valid tokens (visual, then
    audio if any) and a separator, then K Q-Former tokens and a separator
    for each later frame, the queries pooled from the first frame; if the
    total exceeds max_visual, each chunk drops ceil(excess / chunks) of its
    last tokens.  frame_tokens [T, P (+A), H] -> [n_visual, H]."""
    c = cfg.compression
    K = c.context_token_num
    dev = frame_tokens.device
    Pn = len(valid)
    A = frame_tokens.shape[1] - Pn
    tv = torch.from_numpy(np.concatenate([valid, np.ones(A, bool)])).to(dev)
    sep = P.v(p["frame_seg"])[None]
    pool_t = torch.from_numpy(pool).to(dev)
    if text_ids is None:
        text_ids = torch.zeros(64, dtype=torch.long, device=dev)
        text_mask = torch.zeros(64, dtype=torch.bool, device=dev)
    outs = []
    for ch in chunks:
        key = frame_tokens[ch[0]].to(P.dtype)
        pieces = [key[tv], sep]
        others = ch[1:]
        if others:
            pooled = (pool_t @ key[:Pn].float()).to(P.dtype)
            query = lin(p["query_proj"], pooled, P)[None].expand(len(others), -1, -1)
            enc = frame_tokens[others].to(P.dtype)
            # recomputed in a backward (training), so that a chunk's Q-Former
            # internals are not all kept at once
            out = checkpoint(qformer, cfg.qformer, p["qformer"], query, text_ids, text_mask, enc,
                             tv[None].expand(len(others), -1), P, use_reentrant=False)
            comp = lin(p["vision_proj"], out, P).float()
            comp = (comp / torch.sqrt((comp * comp).sum(-1, keepdim=True) + 1e-12)).to(P.dtype)
            for j in range(len(others)):
                pieces += [comp[j], sep]
        outs.append(torch.cat(pieces))
    excess = sum(len(o) for o in outs) - max_visual
    if excess > 0:
        drop = -(-excess // len(outs))
        outs = [o[:max(len(o) - drop, 0)] for o in outs]
    return torch.cat(outs)[:max_visual]


# --- the decoder (its family's file, perfbench/lm/, runs it) -------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-rotation rotary embedding of x [1, N, H, D] at positions pos [N]."""
    D = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float64) / D)
    ang = pos.double()[:, None] * inv[None]
    cos, sin = (torch.cat([f(ang), f(ang)], -1).float()[None, :, None] for f in (torch.cos, torch.sin))
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return (x.float() * cos + torch.cat([-x2, x1], -1).float() * sin).to(x.dtype)


def spliced_prompt(cfg, params, ids: Sequence[int], image_pos: int, visual: torch.Tensor,
                   P: Prec = F32) -> torch.Tensor:
    """The prompt's embeddings with the visual tokens in place of <image>."""
    e = core.lm_family(cfg).embed(cfg.lm, params["lm"], ids, P)
    return torch.cat([e[:image_pos], visual.to(P.dtype), e[image_pos + 1:]])


def served_gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """For each served token, how far its logit lies below the best logit at
    its position (0 for the argmax)."""
    t = torch.as_tensor(list(tokens), device=logits.device).long()
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]
