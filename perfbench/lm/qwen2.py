"""The Qwen2 / Llama dense decoder: grouped-query attention with RoPE,
RMSNorm and a SwiGLU MLP, as the harness knows it.

A configuration names its decoder family by `model.lm.name`, and
core.lm_family finds its file here.  Serving cells call:

- `spec(lc)`: the decoder's parameter tree (perfbench/weights.py's leaves,
  in the order `weights.make` hands out its views);
- `embed(lc, p, ids, P)`, `logits(lc, p, embeds, rows, P)`: the plain
  reference's inference;
- `forward_flops(lc, rows, ctx, logits_rows)`: its model FLOPs;

and training cells also:

- `lora_spec(lc, rank)`: the LoRA factors stage 3 trains, by the port's
  names;
- `hidden(lc, p, lora, scale, x, P)`, `token_loss(lc, p, hidden, targets,
  P)`: the plain reference's training pass;
- `train_flops(lc, rows, lora_rank)`.

Nothing here imports jax or the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench import weights as W
from perfbench.flops import attn_pairs, mm
from perfbench.reference import model as R
from perfbench.reference.train import lora_lin


# --- the parameter tree ---------------------------------------------------

def spec(lc) -> dict:
    H, Fd = lc.hidden_size, lc.intermediate_size
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    b = lc.attention_bias
    lay = {"input_norm": {"scale": ("o", (H,), 0.0)}, "q_proj": W.lin(H, qd, b),
           "k_proj": W.lin(H, kvd, b), "v_proj": W.lin(H, kvd, b), "o_proj": W.lin(qd, H, False),
           "post_attn_norm": {"scale": ("o", (H,), 0.0)},
           "mlp": {"gate": W.lin(H, Fd, False), "up": W.lin(H, Fd, False), "down": W.lin(Fd, H, False)}}
    p = {"embed": {"embedding": W.normal(lc.vocab_size, H)},
         "layers": W.stack(lc.num_layers, lay), "final_norm": {"scale": ("o", (H,), 0.0)}}
    if not lc.tie_word_embeddings:
        p["lm_head"] = W.lin(H, lc.vocab_size, False)
    return p


def lora_spec(lc, rank: int) -> dict:
    """The LoRA factors of every decoder projection, stacked over layers: A
    normal(0, 0.02), B zero (training starts from the base model)."""
    H, Fd, L = lc.hidden_size, lc.intermediate_size, lc.num_layers
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    shapes = {"q_proj": (H, qd), "k_proj": (H, kvd), "v_proj": (H, kvd), "o_proj": (qd, H),
              "mlp/gate": (H, Fd), "mlp/up": (H, Fd), "mlp/down": (Fd, H)}
    return {f"layers/{k}/w": {"a": ("n", (L, i, rank), 0.02), "b": ("z", (L, rank, o), 0.0)}
            for k, (i, o) in shapes.items()}


# --- the reference: inference ---------------------------------------------

def embed(lc, p, ids, P: R.Prec = R.F32) -> torch.Tensor:
    table = p["embed"]["embedding"]
    idx = torch.as_tensor(ids, device=table.device).long().clamp(0, table.shape[0] - 1)
    return P.v(table[idx])


def logits(lc, p, embeds: torch.Tensor, rows: torch.Tensor, P: R.Prec = R.F32) -> torch.Tensor:
    """Causal forward of one sequence embeds [N, H] at positions 0..N-1;
    float32 logits [len(rows), V] at the given rows."""
    N = embeds.shape[0]
    x = embeds.to(P.dtype)[None]
    pos = torch.arange(N, device=x.device)
    hd = lc.head_dim
    for i in range(lc.num_layers):
        lp = R.layer(p["layers"], i)
        h = R.rms(lp["input_norm"], x, lc.rms_norm_eps, P)
        q = R.rope(R.lin(lp["q_proj"], h, P).reshape(1, N, lc.num_heads, hd), pos, lc.rope_theta)
        k = R.rope(R.lin(lp["k_proj"], h, P).reshape(1, N, lc.num_kv_heads, hd), pos, lc.rope_theta)
        v = R.lin(lp["v_proj"], h, P).reshape(1, N, lc.num_kv_heads, hd)
        x = x + R.lin(lp["o_proj"], R.attend(q, k, v, causal_from=0).reshape(1, N, -1), P)
        h = R.rms(lp["post_attn_norm"], x, lc.rms_norm_eps, P)
        m = lp["mlp"]
        x = x + R.lin(m["down"], F.silu(R.lin(m["gate"], h, P)) * R.lin(m["up"], h, P), P)
    h = R.rms(p["final_norm"], x[0, rows], lc.rms_norm_eps, P)
    head = p["embed"]["embedding"].T if lc.tie_word_embeddings else p["lm_head"]["w"]
    return (h @ P.w(head)).float()


# --- the reference: training ----------------------------------------------

def hidden(lc, p, lora, scale: float, x: torch.Tensor, P: R.Prec) -> torch.Tensor:
    """The decoder over one sequence x [N, H] with LoRA (B scaled by
    `scale`, alpha / r); final hidden [N, H]."""
    N = x.shape[0]
    pos = torch.arange(N, device=x.device)
    hd = lc.head_dim

    def one(i, h):
        lp = R.layer(p["layers"], i)
        ab = {k: (lora[k]["a"][i], lora[k]["b"][i]) for k in lora}
        y = R.rms(lp["input_norm"], h, lc.rms_norm_eps, P)
        q = R.rope(lora_lin(lp["q_proj"], y, ab.get("q_proj"), scale, P).reshape(1, N, lc.num_heads, hd),
                   pos, lc.rope_theta)
        k = R.rope(lora_lin(lp["k_proj"], y, ab.get("k_proj"), scale, P).reshape(1, N, lc.num_kv_heads, hd),
                   pos, lc.rope_theta)
        v = lora_lin(lp["v_proj"], y, ab.get("v_proj"), scale, P).reshape(1, N, lc.num_kv_heads, hd)
        h = h + lora_lin(lp["o_proj"], R.attend(q, k, v, causal_from=0).reshape(1, N, -1),
                         ab.get("o_proj"), scale, P)
        y = R.rms(lp["post_attn_norm"], h, lc.rms_norm_eps, P)
        m = lp["mlp"]
        g = lora_lin(m["gate"], y, ab.get("mlp/gate"), scale, P)
        u = lora_lin(m["up"], y, ab.get("mlp/up"), scale, P)
        return h + lora_lin(m["down"], F.silu(g) * u, ab.get("mlp/down"), scale, P)

    h = x.to(P.dtype)[None]
    for i in range(lc.num_layers):
        h = checkpoint(one, i, h, use_reentrant=False)
    return R.rms(p["final_norm"], h[0], lc.rms_norm_eps, P)


def token_loss(lc, p, hidden: torch.Tensor, targets: torch.Tensor, P: R.Prec, chunk: int = 512):
    """Sum of -log p(target) over rows with a target (>= 0), the head
    applied to chunks of rows."""
    head = p["embed"]["embedding"].T if lc.tie_word_embeddings else p["lm_head"]["w"]

    def part(h, t):
        logits = (h @ P.w(head)).float()
        valid = t >= 0
        ll = torch.log_softmax(logits, -1).gather(1, t.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
        return -(ll * valid).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(0, hidden.shape[0], chunk):
        total = total + checkpoint(part, hidden[c:c + chunk], targets[c:c + chunk], use_reentrant=False)
    return total


# --- model FLOPs (products only: 2 per multiply-add) ----------------------

def layer_params(lc) -> int:
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    return lc.hidden_size * (2 * qd + 2 * kvd) + 3 * lc.hidden_size * lc.intermediate_size


def forward_flops(lc, rows: int, ctx: int = 0, logits_rows: int = 1) -> float:
    """Forward of `rows` new positions after `ctx` cached ones, with the head
    over `logits_rows` of them."""
    attn = 4 * lc.head_dim * lc.num_heads * attn_pairs(rows, ctx + rows, True, ctx)
    return (lc.num_layers * (2.0 * rows * layer_params(lc) + attn)
            + mm(logits_rows, lc.hidden_size, lc.vocab_size))


def train_flops(lc, rows: int, lora_rank: int) -> float:
    """One sequence of `rows` through stage-3 LoRA: the frozen decoder's
    forward and its input gradients (2x its products, 12 D a visible pair
    in attention), LoRA's factors 3x, and the head over every row (2x)."""
    H = lc.hidden_size
    qd, kvd = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    lora = sum(mm(rows, i, lora_rank) + mm(rows, lora_rank, o) for i, o in (
        (H, qd), (H, kvd), (H, kvd), (qd, H), (H, lc.intermediate_size), (H, lc.intermediate_size),
        (lc.intermediate_size, H)))
    attn = 12 * lc.head_dim * lc.num_heads * attn_pairs(rows, rows, True)
    return (lc.num_layers * (2 * 2.0 * rows * layer_params(lc) + attn + 3 * lora)
            + 2 * mm(rows, H, lc.vocab_size))
