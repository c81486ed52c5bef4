"""Decoder-only language model core, Qwen2 / Llama-3.x (port of
tdc_video_tpu/models/lm.py).

Layers are stacked on axis 0 and run in a Python loop; `layers` may also be
a list of per-layer trees (the trainer's gradient views, train/step.py).  The
KV cache is a fixed-capacity buffer with a validity mask and per-sample
lengths, as in JAX, in bf16 or int8 (per-token-per-head scales); unlike JAX
it is updated in place (prefill, decode_step and verify_step write the new
keys/values into the cache tensors they are given and return the same
dict), which saves a copy of the whole cache per step.

int8 weights (models/quant.py) run weight-only, or with act_quant=True
(prefill, lm_forward) as s8 x s8 projections.  Speculative decoding:
verify_step writes a K-token window above `lengths` and commit_verified
flips the accepted slots valid; extend_prefill forwards such a window and
commits it (shared-prefix and chunked admission), and decode_step's
`active` mask freezes idle engine slots.

Training: `lm_forward` and `lm_loss` (chunked cross-entropy), with
`remat=True` checkpointing each layer (torch.utils.checkpoint in place of
jax.checkpoint).

Tensor parallelism (`mesh`, parallel/mesh.py): the serving entry points
take the mesh explicitly and run on this rank's shard of the params
(parallel/sharding.lm_param_spec): num_heads/n query and num_kv_heads/n KV
heads a rank (a contiguous split, so a rank's query heads map onto its own
KV heads under GQA), a sum over `model` after o_proj and after the MLP's
down projection (layers.row_parallel_linear), the vocabulary-split
embedding looked up where a rank holds the id and summed (exact), and the
head's logits over each rank's vocabulary slice gathered in rank order, so
that every rank holds the full f32 logits and takes the same token.  The
cache holds num_kv_heads/n heads a rank (kv_cache_spec).  mesh=None is
the one-device code.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import LMConfig
from ..device import resolve_device
from ..parallel.mesh import MODEL_AXIS
from .attention import attention
from .layers import (
    apply_rope,
    dot_f32,
    init_linear,
    init_rms_norm,
    int8_dot,
    int8_qact,
    linear,
    normal_init,
    rms_norm,
    rope_cos_sin,
    rope_inv_freq,
    row_parallel_linear,
    sdpa_int8kv,
    swiglu_mlp,
)

Params = Any


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack(layers):
    """List of identical param trees -> one tree with leaves stacked on axis 0."""
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def _init_layer(gen, cfg: LMConfig, dtype, device):
    bias = cfg.attention_bias
    H, F = cfg.hidden_size, cfg.intermediate_size
    return {
        "input_norm": init_rms_norm(H, dtype, device),
        "q_proj": init_linear(gen, H, cfg.q_dim, dtype, device, bias=bias),
        "k_proj": init_linear(gen, H, cfg.kv_dim, dtype, device, bias=bias),
        "v_proj": init_linear(gen, H, cfg.kv_dim, dtype, device, bias=bias),
        "o_proj": init_linear(gen, cfg.q_dim, H, dtype, device, bias=False),
        "post_attn_norm": init_rms_norm(H, dtype, device),
        "mlp": {
            "gate": init_linear(gen, H, F, dtype, device, bias=False),
            "up": init_linear(gen, H, F, dtype, device, bias=False),
            "down": init_linear(gen, F, H, dtype, device, bias=False),
        },
    }


def init_lm(cfg: LMConfig, gen: torch.Generator, device=None, dtype=torch.float32) -> Params:
    device = resolve_device(device)
    params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, cfg.hidden_size), dtype, device)},
        "layers": _stack([_init_layer(gen, cfg, dtype, device) for _ in range(cfg.num_layers)]),
        "final_norm": init_rms_norm(cfg.hidden_size, dtype, device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = init_linear(gen, cfg.hidden_size, cfg.vocab_size, dtype, device,
                                        bias=False)
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def tp_size(cfg: LMConfig, mesh=None) -> int:
    """The model axis's size n, checked against the LM: n must divide the
    query and KV head counts and the vocabulary (the port does not pad an
    uneven split, where JAX would)."""
    n = 1 if mesh is None else mesh.size(MODEL_AXIS)
    for what, count in (("query heads", cfg.num_heads), ("KV heads", cfg.num_kv_heads),
                        ("vocabulary", cfg.vocab_size)):
        if count % n:
            raise ValueError(f"model axis {n} does not divide the {count} {what}")
    return n


def init_kv_cache(cfg: LMConfig, batch: int, capacity: int, dtype=torch.bfloat16,
                  device=None, quant: Optional[str] = None, mesh=None) -> Dict:
    """Fixed-capacity KV cache [L, B, S, Hkv, D].  quant="int8" stores K/V as
    int8 with f32 per-token-per-head scales [L, B, S, Hkv]: quantized at
    write, read through layers.sdpa_int8kv.  Under a mesh, this rank's
    num_kv_heads/n heads on the mesh's device."""
    device = resolve_device(device if mesh is None else mesh.device)
    heads = cfg.num_kv_heads // tp_size(cfg, mesh)
    shape = (cfg.num_layers, batch, capacity, heads, cfg.head_dim)
    if quant == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "mask": torch.zeros((batch, capacity), dtype=torch.bool, device=device),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    if quant not in (None, "none"):
        raise ValueError(f"unknown kv quant mode {quant!r}")
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "mask": torch.zeros((batch, capacity), dtype=torch.bool, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _quant_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 [..., D], f32 scale [...]): symmetric per vector."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_forward(
    cfg: LMConfig,
    p: Params,
    x: torch.Tensor,  # [B, T, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_mask: Optional[torch.Tensor],  # [B, 1, T, S] bool
    cache_k,  # [B, S, Hkv, D] written in place, or (int8 values, f32 scales [B, S, Hkv])
    cache_v,
    write_pos: Optional[torch.Tensor],  # [B, T] slot indices for the new k/v
    attn_impl: str,
    causal: bool = False,
    act_quant: bool = False,
    verify: bool = False,
    mesh=None,
) -> torch.Tensor:
    B, T, _ = x.shape
    h = rms_norm(p["input_norm"], x, cfg.rms_norm_eps)
    if act_quant and "w_q" in p["q_proj"]:
        # s8 x s8 projections: one shared activation quantization feeds q/k/v
        hq, hs = int8_qact(h)
        q, k, v = (int8_dot(hq, hs, p[n], x.dtype) for n in ("q_proj", "k_proj", "v_proj"))
    else:
        q, k, v = (linear(p[n], h) for n in ("q_proj", "k_proj", "v_proj"))
    # this rank's heads: all of them, or num_heads/n and num_kv_heads/n under TP
    q = apply_rope(q.reshape(B, T, -1, cfg.head_dim), cos, sin)
    k = apply_rope(k.reshape(B, T, -1, cfg.head_dim), cos, sin)
    v = v.reshape(B, T, -1, cfg.head_dim)
    b_idx = None if cache_k is None else torch.arange(B, device=x.device)[:, None]
    if isinstance(cache_k, tuple):
        # int8 cache: quantize at write; never a dequantized cache
        (ck, ks), (cv, vs) = cache_k, cache_v
        kq, ksc = _quant_kv(k)
        vq, vsc = _quant_kv(v)
        ck[b_idx, write_pos], ks[b_idx, write_pos] = kq, ksc
        cv[b_idx, write_pos], vs[b_idx, write_pos] = vq, vsc
        if T > 1 and not verify:
            # single-shot prefill: the cache holds exactly the fresh keys, so
            # attend over the k/v from before quantization (the flash path);
            # mask columns beyond T are sliced off
            m = None if attn_mask is None else attn_mask[..., :T]
            attn = attention(q, k, v, m, impl=attn_impl, causal=causal)
        else:
            # decode, or a verify window over a non-empty cache: the whole
            # quantized cache, the window's fresh keys read back quantized
            # as sequential decode steps would
            attn = sdpa_int8kv(q, ck, ks, cv, vs, attn_mask)
    else:
        if cache_k is not None:
            cache_k[b_idx, write_pos] = k.to(cache_k.dtype)
            cache_v[b_idx, write_pos] = v.to(cache_v.dtype)
            k, v = cache_k, cache_v
        attn = attention(q, k.to(q.dtype), v.to(q.dtype), attn_mask, impl=attn_impl,
                         causal=causal)
    x = x + row_parallel_linear(p["o_proj"], attn.reshape(B, T, -1), mesh, act_quant=act_quant)
    h2 = rms_norm(p["post_attn_norm"], x, cfg.rms_norm_eps)
    return x + swiglu_mlp(p["mlp"], h2, act_quant=act_quant, mesh=mesh)


def lm_backbone(
    cfg: LMConfig,
    params: Params,
    inputs_embeds: torch.Tensor,  # [B, T, H]
    positions: torch.Tensor,  # [B, T]
    attn_mask: Optional[torch.Tensor] = None,  # [B, 1, T, S] bool
    cache: Optional[Dict] = None,
    write_pos: Optional[torch.Tensor] = None,  # [B, T]
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
    causal: bool = False,
    remat: bool = False,
    act_quant: bool = False,
    verify: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Run the decoder stack; returns (final hidden [B,T,H], cache).
    remat=True (training) checkpoints each layer: the backward keeps only the
    layer inputs and recomputes each layer's internals (JAX :241-242).
    verify=True marks a multi-token step over a non-empty cache (speculative
    verify), which reads the whole cache rather than treating T > 1 as a
    single-shot prefill.  mesh: tensor-parallel over its model axis; a
    stacked layer axis split over `data` (FSDP) raises."""
    x = inputs_embeds.to(dtype)
    inv_freq = rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling, device=x.device)
    cos, sin = rope_cos_sin(positions, inv_freq)
    layer_fn = functools.partial(_layer_forward, cfg)
    if remat:
        layer_fn = functools.partial(checkpoint, layer_fn, use_reentrant=False)
    layers = params["layers"]
    if mesh is not None and not isinstance(layers, list):
        n_stacked = layers["input_norm"]["scale"].shape[0]
        if n_stacked != cfg.num_layers:
            raise NotImplementedError(
                f"{n_stacked} of {cfg.num_layers} stacked layers: a layer axis split over "
                "`data` (FSDP) is not run yet (ROADMAP.md queue 1, slice 13)")
    int8_kv = cache is not None and "k_scale" in cache
    for i in range(cfg.num_layers):
        lp = layer_params(layers, i)
        ck = cv = None
        if int8_kv:
            ck, cv = (cache["k"][i], cache["k_scale"][i]), (cache["v"][i], cache["v_scale"][i])
        elif cache is not None:
            ck, cv = cache["k"][i], cache["v"][i]
        x = layer_fn(lp, x, cos, sin, attn_mask, ck, cv, write_pos, attn_impl, causal, act_quant,
                     verify, mesh)
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps), cache


def _tree_index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def layer_params(layers, i: int):
    """Layer i's params from a stacked tree or from a list of per-layer trees."""
    return layers[i] if isinstance(layers, list) else _tree_index(layers, i)


def embed_tokens(cfg: LMConfig, params: Params, input_ids: torch.Tensor, dtype=torch.bfloat16,
                 mesh=None):
    """Token embeddings [..., H].  Under TP each rank holds a contiguous
    V/n-row slice of the table: it looks up the ids that fall in it, zeros
    elsewhere, and the sum over `model` is the full lookup (one rank
    contributes each row: exact)."""
    ids = input_ids.long().clamp(0, cfg.vocab_size - 1)  # guard sentinel ids (<image>=-200)
    table = params["embed"]["embedding"].to(dtype)
    if tp_size(cfg, mesh) == 1:
        return table[ids]
    rows = table.shape[0]
    local = ids - mesh.coords[MODEL_AXIS] * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0)
    return mesh.all_reduce(x, MODEL_AXIS)


def head_weight(cfg: LMConfig, params: Params, dtype
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(w, master): the head's [H, V] operand cast to `dtype`, and the float
    tensor it was cast from, in the same layout (None for an int8 head,
    whose int8 values are only converted)."""
    if cfg.tie_word_embeddings:
        master = params["embed"]["embedding"].T
    elif "w_q" in params["lm_head"]:
        return params["lm_head"]["w_q"].to(dtype), None
    else:
        master = params["lm_head"]["w"]
    return master.to(dtype), master


def lm_head(cfg: LMConfig, params: Params, hidden: torch.Tensor, head=None,
            mesh=None) -> torch.Tensor:
    """f32 logits [B, T, V] (layers.dot_f32).  `head`: head_weight's pair,
    when the caller casts the weight once for many calls (lm_loss).  Under
    TP each rank's logits over its vocabulary slice, gathered over `model`
    in rank order: every rank gets the full logits."""
    w, master = head_weight(cfg, params, hidden.dtype) if head is None else head
    y = dot_f32(hidden, w, master)
    if master is None:  # weight-only int8 head
        y = y * params["lm_head"]["w_scale"]
    if tp_size(cfg, mesh) == 1:
        return y
    return mesh.all_gather(y, MODEL_AXIS, dim=-1)


# ---------------------------------------------------------------------------
# Training / scoring
# ---------------------------------------------------------------------------


def lm_forward(
    cfg: LMConfig,
    params: Params,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,  # [B, T] bool, True = valid
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    remat: bool = False,
    dtype=torch.bfloat16,
    return_hidden: bool = False,
    act_quant: bool = False,
) -> torch.Tensor:
    """Full-sequence causal forward (training / scoring): f32 logits [B,T,V],
    or the final hidden states when return_hidden (the chunked loss applies
    the head itself).  act_quant=True runs int8 weights' projections s8 x s8.
    JAX's seq_axis (sequence sharding) is not ported."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(cfg, params, input_ids, dtype)
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    if positions is None:
        positions = (torch.cumsum(attention_mask.to(torch.int32), dim=1) - 1).clamp_min(0)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
    mask = causal[None, None] & attention_mask.to(torch.bool)[:, None, None, :]
    hidden, _ = lm_backbone(cfg, params, inputs_embeds, positions, mask, attn_impl=attn_impl,
                            dtype=dtype, causal=True, remat=remat, act_quant=act_quant)
    if return_hidden:
        return hidden
    return lm_head(cfg, params, hidden)


def _token_ll(cfg: LMConfig, params: Params, hidden, targets, valid, head) -> torch.Tensor:
    """Sum over valid positions of log p(target): f32 head and log-softmax."""
    logp = torch.log_softmax(lm_head(cfg, params, hidden, head).float(), dim=-1)
    ll = torch.take_along_dim(logp, targets[..., None].long(), dim=-1)[..., 0]
    return (ll * valid).sum()


def lm_loss(
    cfg: LMConfig,
    params: Params,
    inputs_embeds: torch.Tensor,
    labels: torch.Tensor,  # [B, T], IGNORE_INDEX = ignored
    attention_mask: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    attn_impl: str = "xla",
    remat: bool = True,
    dtype=torch.bfloat16,
    loss_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Shifted cross-entropy over valid label positions (JAX :362-443).

    loss_chunk: the head and the log-softmax run over chunks of this many
    positions, each chunk checkpointed, so the backward recomputes a chunk's
    [B, C, V] f32 logits instead of holding the full [B, T, V] (4.2 GB per
    buffer at 8k tokens and a 128k vocabulary).  The head weight is cast to
    the compute dtype once, outside the chunks and their recompute, and its
    gradient accumulates in the master's dtype (layers.dot_f32)."""
    targets = labels[:, 1:]
    valid = targets >= 0
    safe_targets = torch.where(valid, targets, 0).clamp(0, cfg.vocab_size - 1)
    denom = valid.sum().clamp_min(1)
    hidden = lm_forward(cfg, params, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                        positions=positions, attn_impl=attn_impl, remat=remat, dtype=dtype,
                        return_hidden=True)
    h = hidden[:, :-1]
    vf = valid.to(torch.float32)
    head = head_weight(cfg, params, dtype)
    if loss_chunk is None:
        return -_token_ll(cfg, params, h, safe_targets, vf, head) / denom
    C = int(loss_chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], C):
        sl = slice(c0, c0 + C)
        total = total + checkpoint(_token_ll, cfg, params, h[:, sl], safe_targets[:, sl], vf[:, sl],
                                   head, use_reentrant=False)
    return -total / denom


# ---------------------------------------------------------------------------
# Prefill / decode steps
# ---------------------------------------------------------------------------


def prefill(
    cfg: LMConfig,
    params: Params,
    inputs_embeds: torch.Tensor,  # [B, T, H] right-padded
    attention_mask: torch.Tensor,  # [B, T] bool
    cache: Dict,
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
    act_quant: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """Prefill the cache; returns (last-token logits [B, V], cache).  The
    attention runs over the whole capacity-S cache with causal=True: query i
    sees cache slots j <= i (top-left causal, S >= T); over an int8 cache it
    runs on the fresh T keys before quantization.  act_quant=True runs int8
    weights' projections s8 x s8 (decode steps stay weight-only)."""
    B, T, _ = inputs_embeds.shape
    S = cache["k"].shape[2]
    dev = inputs_embeds.device
    am = attention_mask.to(torch.bool)
    positions = (torch.cumsum(am.to(torch.int32), dim=1) - 1).clamp_min(0)
    write_pos = torch.broadcast_to(torch.arange(T, device=dev)[None], (B, T))
    causal = (torch.arange(S, device=dev)[None] <= torch.arange(T, device=dev)[:, None])[None, None]
    key_valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
    key_valid[:, :T] = am
    mask = causal & key_valid[:, None, None, :]
    hidden, cache = lm_backbone(cfg, params, inputs_embeds, positions, mask, cache=cache,
                                write_pos=write_pos, attn_impl=attn_impl, dtype=dtype,
                                causal=True, act_quant=act_quant, mesh=mesh)
    lengths = am.to(torch.int32).sum(-1)
    cache["mask"][:, :T] = am
    cache["lengths"] = lengths
    last = hidden[torch.arange(B, device=dev), (lengths - 1).long()][:, None]  # [B,1,H]
    return lm_head(cfg, params, last, mesh=mesh)[:, 0], cache


def decode_step(
    cfg: LMConfig,
    params: Params,
    token_embeds: torch.Tensor,  # [B, 1, H]
    cache: Dict,
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive slots keep mask and lengths
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step; writes at per-sample `lengths`, returns logits [B, V].
    `active` (continuous batching, serving/batching.py): inactive slots still
    run through the batched products, and their K/V land on their next,
    still-masked slot, but their mask and lengths are left as they were."""
    B = token_embeds.shape[0]
    S = cache["k"].shape[2]
    dev = token_embeds.device
    lengths = cache["lengths"]
    positions = lengths[:, None]
    slot = lengths.clamp_max(S - 1).long()
    write_pos = slot[:, None]
    step_mask = cache["mask"].clone()
    step_mask[torch.arange(B, device=dev), slot] = True
    hidden, cache = lm_backbone(cfg, params, token_embeds, positions, step_mask[:, None, None, :],
                                cache=cache, write_pos=write_pos, attn_impl=attn_impl,
                                dtype=dtype, mesh=mesh)
    if active is None:
        cache["mask"] = step_mask
        cache["lengths"] = lengths + 1
    else:
        cache["mask"] = torch.where(active[:, None], step_mask, cache["mask"])
        cache["lengths"] = lengths + active.to(lengths.dtype)
    return lm_head(cfg, params, hidden, mesh=mesh)[:, 0], cache


def verify_step(
    cfg: LMConfig,
    params: Params,
    token_embeds: torch.Tensor,  # [B, K, H]: the last accepted token + K-1 drafts
    cache: Dict,
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """K-token step for speculative decoding (serving/speculative.py): window
    token j sits at position lengths+j and attends every valid cache slot
    plus window slots 0..j.  Its K/V are written at slots
    lengths..lengths+K-1, but mask and lengths are not advanced:
    commit_verified commits the accepted prefix, and rejected slots are
    garbage above `lengths` that the next window overwrites.  Needs
    lengths + K <= capacity.  Returns (logits [B, K, V], cache)."""
    hidden, cache = _window_forward(cfg, params, token_embeds, cache, attn_impl, dtype, mesh)
    return lm_head(cfg, params, hidden, mesh=mesh), cache


def _window_forward(cfg, params, token_embeds, cache, attn_impl, dtype, mesh=None):
    """Forward a K-token window at the per-sample cache tails, its K/V
    written above `lengths` and not committed.  Returns (hidden, cache)."""
    B, K, _ = token_embeds.shape
    S = cache["k"].shape[2]
    dev = token_embeds.device
    lengths = cache["lengths"]
    offs = torch.arange(K, device=dev)[None]  # [1, K]
    positions = lengths[:, None] + offs
    write_pos = positions.clamp_max(S - 1).long()
    col = torch.arange(S, device=dev)[None, None]  # [1, 1, S]
    start = lengths[:, None, None]
    window = (col >= start) & (col <= start + offs[..., None])  # [B, K, S]
    attn_mask = (cache["mask"][:, None, :] | window)[:, None]  # [B, 1, K, S]
    return lm_backbone(cfg, params, token_embeds, positions, attn_mask, cache=cache,
                       write_pos=write_pos, attn_impl=attn_impl, dtype=dtype, verify=True,
                       mesh=mesh)


def commit_verified(cache: Dict, accept: torch.Tensor) -> Dict:
    """Advance the cache past `accept` [B] verified window tokens (their K/V
    were written by verify_step): flip their mask slots valid and bump
    lengths.  accept=0 leaves a sample untouched."""
    S = cache["k"].shape[2]
    col = torch.arange(S, device=accept.device)[None]
    lengths = cache["lengths"]
    new = (col >= lengths[:, None]) & (col < (lengths + accept)[:, None])
    cache["mask"] = cache["mask"] | new
    cache["lengths"] = lengths + accept.to(lengths.dtype)
    return cache


def extend_prefill(
    cfg: LMConfig,
    params: Params,
    token_embeds: torch.Tensor,  # [B, K, H] right-padded suffix
    n_valid: torch.Tensor,  # [B] true suffix lengths (<= K)
    cache: Dict,
    attn_impl: str = "xla",
    dtype=torch.bfloat16,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """Continue a prefill from the cache tail: one forward of a K-token
    suffix over an already-prefilled cache (verify_step's window), then
    commit exactly `n_valid` tokens.  The committed K/V and the next-token
    logits are those of prefilling prefix + suffix in one shot: the
    shared-prefix and chunked admission of serving/batching.py.  Writes the
    cache in place (copy a donor first to keep it).  Needs lengths + K <=
    capacity.  Returns (logits [B, V] at the last valid suffix token,
    cache)."""
    hidden, cache = _window_forward(cfg, params, token_embeds, cache, attn_impl, dtype, mesh)
    idx = (n_valid - 1).clamp_min(0).long()
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx][:, None]
    return lm_head(cfg, params, last, mesh=mesh)[:, 0], commit_verified(cache, n_valid)
