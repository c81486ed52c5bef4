"""Plain PyTorch reference of a stage-3 training step (audio-visual LoRA):
the loss of one sample and its gradients with respect to the trainable
leaves, and AdamW after one clip of the global gradient norm.

The frozen parts (towers, BEATs, the decoder's base weights, its embedding
and head) run without a graph; the trainable ones are the LoRA factors A
and B of every decoder projection (y = x W + (x A) (B alpha / r)), the SVA,
the compressor, the newline embedding and audio_proj.  The decoder and the
SVA are recomputed in the backward (checkpoints per layer and per block of
frames), as memory demands; the loss is the mean cross-entropy of the
labelled next tokens, its head applied in chunks of rows.  The decoder's
pass and loss are its family's (perfbench/lm/<model.lm.name>.py: `hidden`,
`token_loss`), built on `lora_lin` here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import core
from . import audio as RA
from . import model as R


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, dict keys and list indices joined by /."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix.rstrip("/"), tree)]


def lora_lin(p, x, ab, scale, P: R.Prec):
    y = R.lin(p, x, P)
    if ab is not None:
        a, b = ab
        y = y + (x.to(P.dtype) @ a.to(P.dtype)) @ (b * scale).to(P.dtype)
    return y


def sample_loss(m, params, train: Dict, lora, lora_scale: float, batch: Dict, cuts,
                max_len: int, max_visual: int, P: R.Prec = R.F32, block: int = 16):
    """The mean next-token loss of one sample (batch: the trainer's input
    dict for one sample, tensors on the device) and the cut gap of the
    port's cuts (the reference compresses along them).  `params`: the
    frozen tree; `train`: the trainable leaves' tree (sva, compressor,
    image_newline, audio_proj)."""
    dev = batch["input_ids"].device
    T = int(batch["frame_mask"].shape[1])
    full = dict(params, **train)
    atok = RA.encode_audio(m, full, batch["audio_windows"][0], batch["audio_wmask"][0],
                           batch["audio_frame_of_sec"][0].tolist(), batch["audio_group_pos"][0].tolist(),
                           batch["audio_group_size"][0].tolist(), batch["audio_sec_valid"][0].tolist(),
                           T, P)
    side = int(m.sva.image_token_len ** 0.5)
    ftoks, dinos = [], []
    for t0 in range(0, T, block):
        with torch.no_grad():
            sig = R.vit(m.siglip, params["siglip"], batch["siglip_px"][0, t0:t0 + block].to(P.dtype), P)
            dino = R.vit(m.dino, params["dino"], batch["dino_px"][0, t0:t0 + block].to(P.dtype), P)
        feats = checkpoint(lambda a, b: R.sva(m.sva, train["sva"], [a, b], P), sig, dino,
                           use_reentrant=False)
        B, _, H = feats.shape
        nl = P.v(train["image_newline"]).expand(B, side, 1, H)
        ftoks.append(torch.cat([feats.reshape(B, side, side, H), nl], 2).reshape(B, side * (side + 1), H))
        dinos.append(dino.float())
    ftok = torch.cat(ftoks)
    sims = R.adjacent_similarity(torch.cat(dinos))
    cgap = R.cut_gap(sims, torch.as_tensor(np.asarray(cuts, bool), device=sims.device),
                     m.compression.max_num_segments)
    tokens = torch.cat([ftok, atok.to(ftok.dtype)], 1)
    valid = batch["token_valid"][0].cpu().numpy().astype(bool)
    pool = batch["query_pool"][0].cpu().numpy()
    vis = R.compress(m, train["compressor"], tokens, R.chunks_of(list(np.asarray(cuts, bool)),
                                                                 m.compression.chunk_size),
                     valid, pool, max_visual, P, batch["qformer_text_ids"][0], batch["qformer_text_mask"][0])
    ids = batch["input_ids"][0]
    labels = batch["labels"][0]
    tl, ip = int(batch["text_len"][0]), int(batch["image_pos"][0])
    nv = min(vis.shape[0], max_len - (tl - 1))
    lm = core.lm_family(m)
    text = lm.embed(m.lm, params["lm"], ids[:tl], P)
    seq = torch.cat([text[:ip], vis[:nv].to(P.dtype), text[ip + 1:tl]])[:max_len]
    lab = torch.cat([labels[:ip], torch.full((nv,), -100, device=dev, dtype=labels.dtype),
                     labels[ip + 1:tl]])[:max_len]
    hidden = lm.hidden(m.lm, params["lm"], lora, lora_scale, seq, P)
    targets = lab[1:].long()
    n = (targets >= 0).sum().clamp_min(1)
    return lm.token_loss(m.lm, params["lm"], hidden[:-1], targets, P) / n, cgap


class AdamW:
    """AdamW (decoupled decay 0 here) after one clip of the global norm of
    all gradients to `clip`, lr from `schedule(count)`; the first moment
    after step 1 gives the clipped gradient back as m / (1 - b1)."""

    def __init__(self, named: Sequence[Tuple[str, torch.Tensor]], schedule, clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.named, self.schedule, self.clip = list(named), schedule, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(t) for n, t in self.named}
        self.v = {n: torch.zeros_like(t) for n, t in self.named}
        self.count = 0

    @torch.no_grad()
    def step(self):
        grads = {n: (t.grad if t.grad is not None else torch.zeros_like(t)) for n, t in self.named}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if norm < self.clip else self.clip / float(norm)
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, t in self.named:
            g = grads[n] * scale
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            t.sub_(lr * (self.m[n] / bc1) / ((self.v[n] / bc2).sqrt() + self.eps))
            t.grad = None


def cosine_schedule(base_lr: float, total: int, warmup_ratio: float):
    """Linear warmup from 0 over max(1, int(total * ratio)) steps, then a
    half cosine to 0 at `total`."""
    warm = max(1, int(total * warmup_ratio))
    decay = max(total, warm + 1) - warm

    def lr(count: int) -> float:
        if count < warm:
            return base_lr * count / warm
        return base_lr * 0.5 * (1 + math.cos(math.pi * min(count - warm, decay) / decay))

    return lr


def worst_leaf_gap(port: Dict[str, float], ref: Dict[str, float], names: Sequence[str]) -> float:
    """max over leaves of |port norm - reference norm| / max(reference norm,
    the median leaf's reference norm)."""
    if not names:
        return math.inf
    med = float(np.median([ref[n] for n in names]))
    return max(abs(port[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)
