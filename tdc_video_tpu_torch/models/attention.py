"""Attention dispatch: CUDA kernels for CUDA tensors, plain sdpa otherwise
(port of tdc_video_tpu/models/attention.py).

The JAX rule is kept with "on a TPU" read as "on a CUDA tensor": impl="flash"
sends T >= 128 causal or maskless self-attention to ops/flash_attention.py,
which launches the kernel the JAX package runs on a TPU for those shapes,
with its custom VJP (so the flash path carries gradients); everything else
(decode steps, Q-Former, SVA, CPU tensors) goes to `sdpa`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .layers import sdpa


def default_attn_impl(device) -> str:
    """Device default: the CUDA kernels (forward and backward) for a CUDA
    device, plain attention otherwise (JAX: "flash" on a TPU, "xla"
    elsewhere)."""
    return "flash" if torch.device(device).type == "cuda" else "xla"


def _check_causal_mask(mask: torch.Tensor, T: int, S: int, q_offset: int = 0) -> None:
    """Guard for the flash path's invariant: with causal=True the mask must be
    causal over right-padded keys (the kernel drops the mask).  With a query
    offset the mask is the causal mask's row block [q_offset, q_offset + T)
    (models/lm.py under sequence parallelism): key j visible to row i iff j
    <= i + q_offset and j is valid."""
    m = torch.broadcast_to(mask, mask.shape[:-2] + (T, S)).reshape(-1, T, S)
    key_valid = m[:, T - 1, :]  # the last query row sees every valid key it reaches
    lens = key_valid.sum(-1)
    cols = torch.arange(S, device=mask.device)[None]
    if not torch.equal(key_valid, cols < lens[:, None]):
        raise ValueError("flash causal path requires right-padded keys")
    expected = torch.tril(torch.ones((T, S), dtype=torch.bool, device=mask.device),
                          diagonal=q_offset)[None]
    if not torch.equal(m, expected & key_valid[:, None, :]):
        raise ValueError("flash causal path requires mask == causal & right-padding")


def attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,  # [B, S, Hkv, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, Hq, T, S]
    impl: str = "xla",
    scale: Optional[float] = None,
    causal: bool = False,
    q_offset: int = 0,
) -> torch.Tensor:
    """`causal=True` asserts the mask is causal over right-padded rows, which
    the kernel implements implicitly; mask=None non-causal (ViT full
    attention) also takes the kernel path; any other mask uses sdpa.
    q_offset: the queries are rows q_offset.. of the keys' sequence (a
    rank's block under sequence parallelism): the kernel's causal query
    offset, and the mask the causal mask's row block, which sdpa applies."""
    on_card = q.device.type == "cuda"
    if impl == "flash" and causal and mask is not None and not on_card:
        # The JAX package checks only concrete masks (not under jit); on the
        # card the check would cost a host sync per layer, so there the
        # caller (lm.prefill, lm.lm_forward) carries the invariant, as under jit.
        _check_causal_mask(mask, q.shape[1], k.shape[1], q_offset)
    if impl == "flash" and on_card and q.shape[1] >= 128 and (causal or mask is None):
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale=scale, causal=causal, q_offset=q_offset)
    return sdpa(q, k, v, mask=mask, scale=scale)
