"""Attention kernels for Hopper (port of tdc_video_tpu/ops/flash_attention.py).

Three of the JAX package's six Pallas kernels serve inference, and each has a
CUDA C++ counterpart here (sources in tdc_video_tpu_torch/csrc/):

    K1 flash_kernel             causal GQA prefill      csrc/flash_kernel.cu
    K2 full_attention_nhd       DINOv2 tower (D=64)     csrc/full_attention_nhd.cu
    K3 full_attention_nhd_seqq  SigLIP tower (D=72)     csrc/full_attention_nhd_seqq.cu

All three are instances of one template (csrc/flash_fwd.cuh) that reads q
[B, T, Hq, D] and k/v [B, S, Hkv, D] in place through their strides, so the
JAX package's transposes to [B, H, T, D] are gone.  Each wrapper takes its
plain PyTorch version only for a tensor on the CPU; for a CUDA tensor it
launches its kernel or raises.  `launches` counts kernel launches.

K4 (_full_attention_kernel) and the backward kernels K5/K6 serve training
and are not ported yet; `flash_attention` raises NotImplementedError for the
shapes that would reach K4, before any kernel runs, and models/attention.py
sends those to the plain `sdpa` path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# kernel launches per wrapper (the plain CPU versions do not count)
launches = {"flash_kernel": 0, "full_attention_nhd": 0, "full_attention_nhd_seqq": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Dispatch rule (flash_attention.py:698-735)
# ---------------------------------------------------------------------------


def _nhd_head_block(head_dim: int) -> int:
    """Heads per 128-lane block on the TPU: smallest hb with hb*D % 128 == 0."""
    hb = 1
    while (hb * head_dim) % 128 != 0:
        hb *= 2
    return hb


def select_kernel(T: int, S: int, Hq: int, Hkv: int, D: int, causal: bool) -> str:
    """Which TPU kernel the JAX dispatch runs for these shapes:
    "full_attention_nhd" (K2), "full_attention_nhd_seqq" (K3),
    "full_attention" (K4) or "flash_kernel" (K1)."""
    hb = _nhd_head_block(D)
    if (
        not causal and T == S and S <= 1024 and Hq == Hkv
        and ((hb * D <= 256 and Hq % hb == 0) or (hb == Hq and Hq * D <= 2048))
    ):
        return "full_attention_nhd" if hb * D <= 256 else "full_attention_nhd_seqq"
    if not causal and T == S and S <= 1024:
        return "full_attention"
    return "flash_kernel"


# ---------------------------------------------------------------------------
# Plain versions (same masks, casts and alignment as the kernels)
# ---------------------------------------------------------------------------


def _attention_plain(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,T,Hq,D], k/v [B,S,Hkv,D] -> (o [B,T,Hq,D], lse [B,Hq,T,1] f32).
    Key j is visible to query i iff j < S and (not causal or j <= i): causal
    is top-left aligned even when S > T.  f32 scores scaled after the dot, P
    rounded to the input dtype before PV, o = acc / max(l, 1e-30)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qh = q.permute(0, 2, 1, 3).float()  # b h t d
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).float()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = scale * (qh @ kh.transpose(-1, -2))  # b h t s
    if causal:
        vis = torch.arange(S, device=q.device)[None, :] <= torch.arange(T, device=q.device)[:, None]
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(vis, p, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(v.dtype).float() @ vh.float()) / l
    lse = m + torch.log(l)
    return o.to(q.dtype).permute(0, 2, 1, 3), lse


def flash_attention_plain(q, k, v, scale: float, causal: bool = True):
    """Plain version of K1: returns (o [B,T,Hq,D], lse [B,Hq,T,1] f32)."""
    return _attention_plain(q, k, v, scale, causal)


def full_attention_nhd_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K2: non-causal full attention, [B,N,H,D] layout."""
    return _attention_plain(q, k, v, scale, False)[0]


def full_attention_nhd_seqq_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K3 (same math as K2; the TPU split is a VMEM artifact)."""
    return _attention_plain(q, k, v, scale, False)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, nhd: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise ValueError(f"q/k/v must share dtype bf16 or f32, got {q.dtype}/{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {t.stride()}")
    B, T, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if Hq % k.shape[2] != 0 or not 0 < D <= 128:
        raise ValueError(f"unsupported heads/head_dim: Hq={Hq} Hkv={k.shape[2]} D={D}")
    if nhd and (k.shape[1] != T or k.shape[2] != Hq):
        raise ValueError("NHD kernels need T == S and Hq == Hkv")
    if max(B, T, k.shape[1], Hq) >= 2**31:
        raise ValueError("sizes exceed int32")
    if q.dtype == torch.bfloat16:
        # the bf16 kernels move operands in 16-byte chunks (cp.async)
        if D % 8 != 0:
            raise ValueError(f"bf16 kernels need head_dim % 8 == 0, got {D}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 != 0 or any(s % 8 != 0 for s in t.stride()[:3]):
                raise ValueError(f"{name} must be 16-byte aligned with strides divisible by 8, "
                                 f"strides {t.stride()}")


def _launch(name: str, q, k, v, scale: float, causal: bool, with_lse: bool):
    from . import build

    _check(q, k, v, nhd=name != "flash_kernel")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, T, 1), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    lib = build.load(name)
    err = getattr(lib, f"tdc_{name}_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.float32), B, T, S, Hq, Hkv, D, S, strides,
        int(causal), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.tdc_error_string(err).decode()} ({err})")
    launches[name] += 1
    return o, lse


def _route(q) -> bool:
    """True: launch the kernel (CUDA tensor).  False: plain version (CPU)."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {q.device}")


def flash_kernel(q, k, v, scale: float, causal: bool = True):
    """K1: causal (or full) GQA attention -> (o [B,T,Hq,D], lse [B,Hq,T,1])."""
    if not _route(q):
        return flash_attention_plain(q, k, v, scale, causal)
    return _launch("flash_kernel", q, k, v, scale, causal, with_lse=True)


def full_attention_nhd(q, k, v, scale: float) -> torch.Tensor:
    """K2: non-causal attention over [B,N,H,D] (packed [B,N,H*D]) in place."""
    if not _route(q):
        return full_attention_nhd_plain(q, k, v, scale)
    return _launch("full_attention_nhd", q, k, v, scale, False, with_lse=False)[0]


def full_attention_nhd_seqq(q, k, v, scale: float) -> torch.Tensor:
    """K3: as K2, for head dims with a wide TPU lane block (SigLIP D=72)."""
    if not _route(q):
        return full_attention_nhd_seqq_plain(q, k, v, scale)
    return _launch("full_attention_nhd_seqq", q, k, v, scale, False, with_lse=False)[0]


def flash_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: Optional[bool] = None,
) -> torch.Tensor:
    """The JAX dispatch unchanged: runs the kernel the JAX package would run
    on a TPU for these shapes."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if causal is None:
        causal = T == S  # prefill
    if not causal and mask is not None:
        raise NotImplementedError("arbitrary masks use the plain sdpa path")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    name = select_kernel(T, S, Hq, Hkv, D, causal)
    if name == "full_attention_nhd":
        return full_attention_nhd(q, k, v, scale)
    if name == "full_attention_nhd_seqq":
        return full_attention_nhd_seqq(q, k, v, scale)
    if name == "full_attention":
        raise NotImplementedError("K4 (_full_attention_kernel) is not ported yet")
    return flash_kernel(q, k, v, scale, causal)[0]
