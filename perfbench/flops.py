"""Operation and byte counts for the rooflines and for `mfu`, and the card's
peaks.  Counts are of the work the inputs need, whatever implements it.

Attention: 4 * D FLOPs per visible (query, key) pair and head forward (the
scores and the weighted sum), 10 * D backward (the scores again, dP, dQ, dK
and dV), so a fused backward is judged on the same work as K5 + K6.  Bytes:
q, k, v and o read or written once (plus the f32 lse where it is written);
backward: q, k, v, dO, lse and delta read, dQ, dK and dV written.
"""

from __future__ import annotations

from . import core

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 bandwidth
# (at the 700 W power limit; the run reports the card's own limit beside).
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: compute- or memory-bound."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attn_pairs(T: int, S: int, causal: bool, q_offset: int = 0) -> int:
    """Visible (query, key) pairs of one head: all T * S without a mask;
    causal, query i (row q_offset + i) sees keys j <= q_offset + i, j < S."""
    if not causal:
        return T * S
    n = max(0, min(T, S - q_offset))  # rows whose last visible key is inside S
    return n * q_offset + n * (n + 1) // 2 + (T - n) * S


def attn_fwd(B, T, S, Hq, Hkv, D, causal, q_offset=0, with_lse=False, elt=2):
    """(FLOPs, bytes) of one forward attention call."""
    flops = 4 * D * attn_pairs(T, S, causal, q_offset) * Hq * B
    nbytes = elt * B * D * (2 * T * Hq + 2 * S * Hkv) + (4 * B * Hq * T if with_lse else 0)
    return flops, nbytes


def attn_bwd(B, T, S, Hq, Hkv, D, causal, q_offset=0, elt=2):
    """(FLOPs, bytes) of one attention call's backward (dQ, dK, dV)."""
    flops = 10 * D * attn_pairs(T, S, causal, q_offset) * Hq * B
    nbytes = elt * B * D * (3 * T * Hq + 4 * S * Hkv) + 8 * B * Hq * T
    return flops, nbytes


# --- model FLOPs (products only: 2 per multiply-add) ---------------------

def mm(rows, d_in, d_out) -> float:
    return 2.0 * rows * d_in * d_out


def vit(vc, frames: int) -> float:
    """One tower over `frames` frames."""
    g = vc.image_size // vc.patch_size
    n = g * g + (1 if vc.use_cls_token else 0)
    d, f = vc.hidden_size, vc.intermediate_size
    mlp = mm(n, d, 2 * f) + mm(n, f, d) if vc.use_swiglu else mm(n, d, f) + mm(n, f, d)
    per_layer = 4 * mm(n, d, d) + mlp + 4 * d * n * n
    return frames * (mm(g * g, vc.patch_size ** 2 * 3, d) + vc.num_layers * per_layer)


def sva(sc, tower_dims, H: int, frames: int) -> float:
    d = sc.vision_hidden_size
    tok = sc.tower_token_len_list
    aux = sum(mm(t, td, d) + mm(t, d, d) for t, td in zip(tok, tower_dims))
    nq = sc.query_num_list[0]
    kv_rows = sum(tok)
    layer = (mm(1, d, d) + mm(nq, 2 * d, d) + mm(nq, d, d) + 2 * mm(kv_rows, d, d)
             + 4 * d * kv_rows + mm(nq, d, d) + 2 * mm(nq, d, d))
    return frames * (aux + sc.connector_depth * layer + mm(nq, d, H) + mm(nq, H, H))


def qformer_pair(qc, K: int, enc_tokens: int, H: int) -> float:
    """The Q-Former's K query rows over one frame's `enc_tokens` encoder
    tokens, with vision_proj (the request carries no Q-Former text)."""
    d = qc.hidden_size
    ffn = mm(K, d, qc.intermediate_size) + mm(K, qc.intermediate_size, d)
    self_attn = 4 * mm(K, d, d) + 4 * d * K * K
    cross = 2 * mm(K, d, d) + 2 * mm(enc_tokens, qc.encoder_width, d) + 4 * d * K * enc_tokens
    n_cross = len(range(0, qc.num_layers, qc.cross_attention_freq))
    return qc.num_layers * (self_attn + ffn) + n_cross * cross + mm(K, d, H)


def answer(cfg, frames: int, chunks: int, valid_tokens: int, prompt_rows: int,
           new_tokens: int) -> float:
    """One request: towers, SVA, compression (a query_proj per chunk, the
    Q-Former per later frame), the prefill and each decode step (the
    decoder's count from its family, perfbench/lm/)."""
    lm = core.lm_family(cfg)
    H, K = cfg.lm.hidden_size, cfg.compression.context_token_num
    f = vit(cfg.siglip, frames) + vit(cfg.dino, frames)
    f += sva(cfg.sva, (cfg.siglip.hidden_size, cfg.dino.hidden_size), H, frames)
    f += chunks * mm(K, H, cfg.qformer.hidden_size)
    f += (frames - chunks) * qformer_pair(cfg.qformer, K, valid_tokens, H)
    f += lm.forward_flops(cfg.lm, prompt_rows)
    for i in range(1, new_tokens):
        f += lm.forward_flops(cfg.lm, 1, prompt_rows + i - 1)
    return f


FORWARD = ("flash_kernel", "full_attention_nhd", "full_attention_nhd_seqq", "full_attention")


def launch_bound_s(launch: dict) -> float:
    """The least time of one recorded kernel launch (name, q and k shapes,
    causal, q_offset, lse): a forward call's own work; a backward call's
    whole work (dQ, dK and dV) on its K5 launch, none on its K6 launch, so
    that the pair is set against the sum of both kernels' times."""
    B, T, Hq, D = launch["q"]
    S, Hkv = launch["k"][1], launch["k"][2]
    if launch["name"] in FORWARD:
        return bound_s(*attn_fwd(B, T, S, Hq, Hkv, D, launch["causal"], launch["q_offset"], launch["lse"]))
    if launch["name"] == "flash_dq_kernel":
        return bound_s(*attn_bwd(B, T, S, Hq, Hkv, D, launch["causal"], launch["q_offset"]))
    return 0.0


def roofline_pct(run, names, kernel_marks) -> "float | None":
    """Sum of the bounds of the traced slice's launches of `names` over the
    device time of its kernels whose names hold one of `kernel_marks`."""
    if run.trace is None:
        return None
    bound = sum(launch_bound_s(x) for x in run.launches if x["name"] in names)
    t = sum(d for n, d in run.trace["kernels"] if any(k in n for k in kernel_marks))
    return 100.0 * bound / t if bound > 0 and t > 0 else None


def beats(bc, windows: int) -> float:
    """BEATs over `windows` 10-s windows (496 tokens each)."""
    n, d, e = 496, bc.encoder_embed_dim, bc.embed_dim
    conv = 2.0 * n * d * (d // 16) * 128
    layer = 4 * mm(n, d, d) + 2 * mm(n, d, bc.ffn_dim) + 4 * d * n * n
    return windows * (mm(n, bc.patch_size ** 2, e) + mm(n, e, d) + conv + bc.num_layers * layer)


def train_sample(cfg, frames: int, chunks, rows: int, lora_rank: int = 128) -> float:
    """One stage-3 micro-step: the frozen towers and BEATs forward; the SVA,
    compression and audio_proj forward and backward (input and weight
    gradients: 3x forward); the decoder with its LoRA factors and head
    (its family's `train_flops`).  Recomputation is not counted."""
    lc, c = cfg.lm, cfg.compression
    H, K = lc.hidden_size, c.context_token_num
    f = vit(cfg.siglip, frames) + vit(cfg.dino, frames) + beats(cfg.beats, -(-frames // 10))
    trained = sva(cfg.sva, (cfg.siglip.hidden_size, cfg.dino.hidden_size), H, frames)
    trained += mm(frames * 50, cfg.beats.encoder_embed_dim, H)
    side = int(cfg.sva.image_token_len ** 0.5)
    enc = side * (side + 1) + 50
    n_chunks = len(chunks)
    trained += n_chunks * mm(K, H, cfg.qformer.hidden_size)
    trained += (frames - n_chunks) * qformer_pair(cfg.qformer, K, enc, H)
    f += 3 * trained
    return f + core.lm_family(cfg).train_flops(lc, rows, lora_rank)
