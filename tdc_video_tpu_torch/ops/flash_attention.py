"""Attention kernels for Hopper (port of tdc_video_tpu/ops/flash_attention.py).

Each of the JAX package's six Pallas kernels has a CUDA C++ counterpart here
(sources in tdc_video_tpu_torch/csrc/):

    K1 flash_kernel             causal GQA forward, f32 lse    csrc/flash_kernel.cu
    K2 full_attention_nhd       DINOv2 tower (D=64)            csrc/full_attention_nhd.cu
    K3 full_attention_nhd_seqq  SigLIP tower (D=72)            csrc/full_attention_nhd_seqq.cu
    K4 full_attention           non-causal T == S <= 1024, lse csrc/full_attention.cu
    K5 flash_dq_kernel          dQ by recomputation            csrc/flash_dq_kernel.cu
    K6 flash_dkv_kernel         dK, dV and the GQA group sum   csrc/flash_dkv_kernel.cu

The bf16 bodies of the four forward kernels K1-K4 (head dims above 32) are
one sm_90a template (csrc/flash_fwd_sm90.cuh: a producer warp feeding a TMA
ring, consumer warpgroups running both products as wgmma, an instance per
padded head dim, the one at 64 tuned for the towers' short sequences), those
of K5 and K6 share csrc/flash_bwd.cuh; all are written with TMA, mbarriers,
wgmma and warp specialisation (csrc/sm90.cuh).  At head dims up to 32 the
forward kernels keep the mma.sync body of csrc/flash_fwd.cuh, and every f32
call runs its scalar body.  All read q/dO [B, T, Hq, D] and k/v [B, S, Hkv,
D] in place through their strides, so the JAX package's transposes to [B, H,
T, D] are gone; bf16 operands are read through 4-D TMA tensor maps whose
strides `operand_strides` passes.  Each wrapper takes its plain PyTorch version only
for a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
`launches` counts kernel launches; while the span recorder records
(utils/profiling.py), each launch is recorded with its shapes.

K1, K5 and K6 take a causal query offset (sequence parallelism, models/lm.py
`lm_forward(seq_axis=)`): key j is visible to query i iff j < kv_len and
(not causal or j <= i + q_offset), so a rank's block of T queries at rows
q_offset.. attends every earlier key of the whole sequence of S keys.  The
JAX package has no such argument (GSPMD slices its masked call); q_offset=0
is every call of the JAX dispatch, top-left aligned when S > T.

Gradients follow the JAX custom VJPs: `_FlashCore` (K1 or K4 forward with
the lse; backward delta, K5, K6) mirrors `_flash_core`, and `_FlashFullNHD`
(K2 or K3 forward; backward recomputes o and lse with K4, then K5 and K6)
mirrors `_flash_full_nhd`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..utils import profiling
from . import build

NEG_INF = -1e30

# kernel launches per wrapper (the plain CPU versions do not count)
launches = {"flash_kernel": 0, "full_attention_nhd": 0, "full_attention_nhd_seqq": 0,
            "full_attention": 0, "flash_dq_kernel": 0, "flash_dkv_kernel": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Dispatch rule (flash_attention.py:698-735 and _flash_gqa :377)
# ---------------------------------------------------------------------------


def _nhd_head_block(head_dim: int) -> int:
    """Heads per 128-lane block on the TPU: smallest hb with hb*D % 128 == 0."""
    hb = 1
    while (hb * head_dim) % 128 != 0:
        hb *= 2
    return hb


def _is_full(T: int, S: int, causal: bool) -> bool:
    """_flash_gqa's rule for the full-attention kernel K4."""
    return not causal and T == S and S <= 1024


def select_kernel(T: int, S: int, Hq: int, Hkv: int, D: int, causal: bool) -> str:
    """Which TPU kernel the JAX dispatch runs for these shapes (forward):
    "full_attention_nhd" (K2), "full_attention_nhd_seqq" (K3),
    "full_attention" (K4) or "flash_kernel" (K1)."""
    hb = _nhd_head_block(D)
    if (
        _is_full(T, S, causal) and Hq == Hkv
        and ((hb * D <= 256 and Hq % hb == 0) or (hb == Hq and Hq * D <= 2048))
    ):
        return "full_attention_nhd" if hb * D <= 256 else "full_attention_nhd_seqq"
    if _is_full(T, S, causal):
        return "full_attention"
    return "flash_kernel"


# ---------------------------------------------------------------------------
# Plain versions (same masks, casts and alignment as the kernels)
# ---------------------------------------------------------------------------


def _visible(T: int, S: int, q_offset: int, device) -> torch.Tensor:
    """[T, S] bool: key j visible to query i under the causal mask, j <= i +
    q_offset."""
    return (torch.arange(S, device=device)[None, :]
            <= torch.arange(T, device=device)[:, None] + q_offset)


def _check_offset(T: int, S: int, q_offset: int) -> None:
    """The causal query offset's range, checked before any launch: a
    negative offset, or a positive one that puts the block past the keys
    (q_offset + T > S), raises ValueError.  q_offset=0 is any call."""
    if q_offset < 0 or (q_offset > 0 and q_offset + T > S):
        raise ValueError(f"causal query offset {q_offset} out of range for T={T} queries "
                         f"over S={S} keys (0 <= q_offset, q_offset + T <= S)")


def _attention_plain(q, k, v, scale: float, causal: bool,
                     q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,T,Hq,D], k/v [B,S,Hkv,D] -> (o [B,T,Hq,D], lse [B,Hq,T,1] f32).
    Key j is visible to query i iff j < S and (not causal or j <= i +
    q_offset): at q_offset=0 causal is top-left aligned even when S > T.
    f32 scores scaled after the dot, P rounded to the input dtype before PV,
    o = acc / max(l, 1e-30)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qh = q.permute(0, 2, 1, 3).float()  # b h t d
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1).float()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    s = scale * (qh @ kh.transpose(-1, -2))  # b h t s
    if causal:
        vis = _visible(T, S, q_offset, q.device)
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = torch.where(vis, p, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(v.dtype).float() @ vh.float()) / l
    lse = m + torch.log(l)
    return o.to(q.dtype).permute(0, 2, 1, 3), lse


def flash_attention_plain(q, k, v, scale: float, causal: bool = True, q_offset: int = 0):
    """Plain version of K1: returns (o [B,T,Hq,D], lse [B,Hq,T,1] f32)."""
    return _attention_plain(q, k, v, scale, causal, q_offset)


def full_attention_nhd_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K2: non-causal full attention, [B,N,H,D] layout."""
    return _attention_plain(q, k, v, scale, False)[0]


def full_attention_nhd_seqq_plain(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K3 (same math as K2; the TPU split is a VMEM artifact)."""
    return _attention_plain(q, k, v, scale, False)[0]


def full_attention_plain(q, k, v, scale: float):
    """Plain version of K4: non-causal, T == S; (o, lse [B,Hq,T,1] f32)."""
    return _attention_plain(q, k, v, scale, False)


def _bwd_terms(q, k, v, do, lse, delta, scale: float, causal: bool, q_offset: int = 0):
    """Per KV head hk: (query-head slice, q, k, dO of the group as [B,g,T,D]
    or [B,1,S,D], P and dS [B,g,T,S] f32), the recomputed terms of
    _flash_gqa_bwd: P = exp(scale Q K^T - lse) masked, dS = P (dO V^T - delta).
    One KV head at a time bounds the [T, S] buffers."""
    T, Hq = q.shape[1], q.shape[2]
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    vis = _visible(T, S, q_offset, q.device) if causal else None
    for hk in range(Hkv):
        hs = slice(hk * g, (hk + 1) * g)
        qh = q[:, :, hs].permute(0, 2, 1, 3)
        doh = do[:, :, hs].permute(0, 2, 1, 3)
        kh = k[:, :, hk : hk + 1].permute(0, 2, 1, 3)
        vh = v[:, :, hk : hk + 1].permute(0, 2, 1, 3)
        p = torch.exp(scale * (qh.float() @ kh.float().transpose(-1, -2)) - lse[:, hs])
        if causal:
            p = torch.where(vis, p, 0.0)
        ds = p * (doh.float() @ vh.float().transpose(-1, -2) - delta[:, hs])
        yield hk, hs, qh, kh, doh, p, ds


def flash_dq_plain(q, k, v, do, lse, delta, scale: float, causal: bool,
                   q_offset: int = 0) -> torch.Tensor:
    """Plain version of K5: dQ = scale * dS(input dtype) K, [B,T,Hq,D].
    lse and delta are [B,Hq,T,1] f32."""
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    for _, hs, _, kh, _, _, ds in _bwd_terms(q, k, v, do, lse, delta, scale, causal, q_offset):
        dq[:, :, hs] = (scale * (ds.to(q.dtype).float() @ kh.float())).to(q.dtype).permute(0, 2, 1, 3)
    return dq


def flash_dkv_plain(q, k, v, do, lse, delta, scale: float, causal: bool, q_offset: int = 0):
    """Plain version of K6: (dK, dV) [B,S,Hkv,D].  Per query head in f32,
    dK = scale * dS(input dtype)^T Q and dV = P(input dtype)^T dO, summed over
    each GQA group in f32, then cast (_flash_gqa_bwd :638-640).  Keys that no
    query sees get exact zeros."""
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    for hk, _, qh, _, doh, p, ds in _bwd_terms(q, k, v, do, lse, delta, scale, causal, q_offset):
        dk_h = scale * (ds.to(q.dtype).float().transpose(-1, -2) @ qh.float())  # b g s d
        dv_h = p.to(v.dtype).float().transpose(-1, -2) @ doh.float()
        dk[:, :, hk] = dk_h.sum(1).to(k.dtype)
        dv[:, :, hk] = dv_h.sum(1).to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, same_len: bool = False, same_heads: bool = False, extra=()) -> None:
    """Device, dtype, shape, stride and alignment checks before a launch.
    `extra` are more (name, tensor) operands shaped like q (dO)."""
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise ValueError(f"q/k/v must share dtype bf16 or f32, got {q.dtype}/{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim, strides {t.stride()}")
        if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 != 0 or any(s % 8 != 0 for s in t.stride()[:3])
        ):
            # the bf16 kernels move operands in 16-byte chunks (cp.async, TMA)
            raise ValueError(f"{name} must be 16-byte aligned with strides divisible by 8, "
                             f"strides {t.stride()}")
    B, T, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)}, got {tuple(t.shape)}")
    if Hq % k.shape[2] != 0 or not 0 < D <= 128:
        raise ValueError(f"unsupported heads/head_dim: Hq={Hq} Hkv={k.shape[2]} D={D}")
    if same_len and k.shape[1] != T:
        raise ValueError(f"this kernel needs T == S, got T={T} S={k.shape[1]}")
    if same_heads and k.shape[2] != Hq:
        raise ValueError("NHD kernels need Hq == Hkv")
    if max(B, T, k.shape[1], Hq) >= 2**31:
        raise ValueError("sizes exceed int32")
    if q.dtype == torch.bfloat16 and D % 8 != 0:
        raise ValueError(f"bf16 kernels need head_dim % 8 == 0, got {D}")


def tma_operand(t) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The 4-D TMA tensor map that the sm_90a kernels (K1-K6) build
    over a bf16 operand [B, L, H, D]: dims innermost first (D, H, L, B) and
    the byte strides of H, L and B, which the launch passes and csrc/sm90.cuh
    make_map uses as they are.  A dim of size 1 gets the stride a packed
    tensor would have there (its stride is never used).  Raises ValueError
    where a tensor map cannot describe the operand: each stride a positive
    multiple of 16 bytes below 2**40."""
    B, L, H, D = t.shape
    sb, sl, sh = t.stride()[:3]
    dims = (D, H, L, B)
    strides, packed = [], 2 * D
    for size, stride in ((H, sh), (L, sl), (B, sb)):
        s = packed if size == 1 else 2 * stride
        if s % 16 != 0 or not 0 < s < 2**40:
            raise ValueError(f"a TMA tensor map cannot describe strides {t.stride()} of shape "
                             f"{tuple(t.shape)}")
        strides.append(s)
        packed = s * size
    return dims, tuple(strides)


def operand_strides(t) -> Tuple[int, int, int]:
    """The (batch, row, head) element strides a launch of an sm_90a kernel
    passes for q, k, v or dO: for bf16, those of the operand's tensor map
    (tma_operand)."""
    if t.dtype != torch.bfloat16:
        return tuple(t.stride()[:3])
    sh, sl, sb = (s // 2 for s in tma_operand(t)[1])
    return sb, sl, sh


def fwd_operand_strides(name: str, q, k, v) -> Tuple[int, ...]:
    """The (batch, row, head) element strides of q, k and v that `_launch`
    passes to forward kernel `name`: those of their tensor maps
    (operand_strides), since the bf16 bodies of all four forward kernels read
    through TMA.  Raises ValueError, before any launch, where a tensor map
    cannot describe a bf16 operand (a batch broadcast with stride 0, a
    stride off a 16-byte multiple); f32 operands pass their own strides."""
    if build.SM90.get(name) != "flash_fwd_bf16_sm90_kernel":
        raise ValueError(f"{name} is not an sm_90a forward kernel")
    return (*operand_strides(q), *operand_strides(k), *operand_strides(v))


def _raise_on_error(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.tdc_error_string(err).decode()} ({err})")


def _launch(name: str, q, k, v, scale: float, causal: bool, with_lse: bool, q_offset: int = 0):
    """One forward kernel (K1-K4): (o [B,T,Hq,D], lse [B,Hq,T,1] f32 or None).
    q_offset: K1's causal query offset (the other three take none)."""
    nhd = name in ("full_attention_nhd", "full_attention_nhd_seqq")
    _check(q, k, v, same_len=name != "flash_kernel", same_heads=nhd)
    qkv_strides = fwd_operand_strides(name, q, k, v)
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, T, 1), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(*qkv_strides, *o.stride()[:3])
    lib = build.load(name)
    offset = (int(q_offset),) if name == "flash_kernel" else ()
    err = getattr(lib, build.entry_point(name))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        int(q.dtype == torch.float32), B, T, S, Hq, Hkv, D, S, strides,
        int(causal), *offset, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error(lib, name, err)
    launches[name] += 1
    profiling.launch(name, q, k, causal, q_offset, with_lse)
    return o, lse


def _launch_bwd(name: str, q, k, v, do, lse, delta, scale: float, causal: bool,
                q_offset: int = 0):
    """One backward kernel: K5 returns dQ, K6 returns (dK, dV)."""
    _check(q, k, v, extra=(("dO", do),))
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    for n, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.device != q.device or t.numel() != B * Hq * T
                or not t.is_contiguous()):
            raise ValueError(f"{n} must be a contiguous f32 [B, Hq, T, 1] tensor on {q.device}")
    new = lambda shape: torch.empty(shape, dtype=q.dtype, device=q.device)
    dq = new((B, T, Hq, D)) if name == "flash_dq_kernel" else None
    dk, dv = (new((B, S, Hkv, D)), new((B, S, Hkv, D))) if name == "flash_dkv_kernel" else (None, None)
    st = lambda t: t.stride()[:3] if t is not None else (0, 0, 0)
    strides = (ctypes.c_int64 * 21)(*(s for t in (q, k, v, do) for s in operand_strides(t)),
                                    *st(dq), *st(dk), *st(dv))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = build.load(name)
    err = getattr(lib, build.entry_point(name))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        ptr(dq), ptr(dk), ptr(dv), int(q.dtype == torch.float32), B, T, S, Hq, Hkv, D, S,
        strides, int(causal), int(q_offset), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on_error(lib, name, err)
    launches[name] += 1
    profiling.launch(name, q, k, causal, q_offset)
    return dq if name == "flash_dq_kernel" else (dk, dv)


def _route(q) -> bool:
    """True: launch the kernel (CUDA tensor).  False: plain version (CPU)."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {q.device}")


def flash_kernel(q, k, v, scale: float, causal: bool = True, q_offset: int = 0):
    """K1: causal (or full) GQA attention -> (o [B,T,Hq,D], lse [B,Hq,T,1]);
    q_offset: the causal query offset (module docstring)."""
    _check_offset(q.shape[1], k.shape[1], q_offset)
    if not _route(q):
        return flash_attention_plain(q, k, v, scale, causal, q_offset)
    return _launch("flash_kernel", q, k, v, scale, causal, with_lse=True, q_offset=q_offset)


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


def full_attention(q, k, v, scale: float):
    """K4: non-causal attention with T == S -> (o [B,T,Hq,D], lse [B,Hq,T,1])."""
    if not _route(q):
        return full_attention_plain(q, k, v, scale)
    return _launch("full_attention", q, k, v, scale, False, with_lse=True)


def flash_dq_kernel(q, k, v, do, lse, delta, scale: float, causal: bool,
                    q_offset: int = 0) -> torch.Tensor:
    """K5: dQ [B,T,Hq,D] from q, k, v, dO, lse and delta ([B,Hq,T,1] f32)."""
    _check_offset(q.shape[1], k.shape[1], q_offset)
    if not _route(q):
        return flash_dq_plain(q, k, v, do, lse, delta, scale, causal, q_offset)
    return _launch_bwd("flash_dq_kernel", q, k, v, do, lse, delta, scale, causal, q_offset)


def flash_dkv_kernel(q, k, v, do, lse, delta, scale: float, causal: bool, q_offset: int = 0):
    """K6: (dK, dV) [B,S,Hkv,D], summed over each GQA group; zero for the
    keys no query sees."""
    _check_offset(q.shape[1], k.shape[1], q_offset)
    if not _route(q):
        return flash_dkv_plain(q, k, v, do, lse, delta, scale, causal, q_offset)
    return _launch_bwd("flash_dkv_kernel", q, k, v, do, lse, delta, scale, causal, q_offset)


# ---------------------------------------------------------------------------
# Autograd (the JAX custom VJPs)
# ---------------------------------------------------------------------------


def _gqa_fwd(q, k, v, scale: float, causal: bool, q_offset: int = 0):
    """_flash_gqa: (o, lse) from K4 for non-causal T == S <= 1024, else K1."""
    if _is_full(q.shape[1], k.shape[1], causal):
        return full_attention(q, k, v, scale)
    return flash_kernel(q, k, v, scale, causal, q_offset)


def _gqa_bwd(q, k, v, o, lse, do, scale: float, causal: bool, q_offset: int = 0):
    """_flash_gqa_bwd: delta = rowsum(dO * O) in f32 outside the kernels
    (:579), then K5 and K6."""
    do = do.contiguous()
    if do.data_ptr() % 16 != 0:  # a view at an odd offset: the kernels load 16-byte chunks
        do = do.clone()
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    dq = flash_dq_kernel(q, k, v, do, lse, delta, scale, causal, q_offset)
    dk, dv = flash_dkv_kernel(q, k, v, do, lse, delta, scale, causal, q_offset)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """_flash_core (:644-670): forward K1 (or K4) saving q, k, v, o and the
    f32 lse; backward K5 and K6, all at the same causal query offset."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, q_offset: int = 0):
        o, lse = _gqa_fwd(q, k, v, scale, causal, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.q_offset = scale, causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _gqa_bwd(q, k, v, o, lse, do, ctx.scale, ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None, None


class _FlashFullNHD(torch.autograd.Function):
    """_flash_full_nhd (:327-361): forward K2 or K3 over [B,N,H,D] saving
    only q, k and v; backward recomputes o and lse with K4, then runs K5 and
    K6 non-causal with one query head per KV head, reading [B,N,H,D] in place
    (the JAX package transposes to [B,H,N,D] here)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, name: str):
        o = full_attention_nhd(q, k, v, scale) if name == "full_attention_nhd" \
            else full_attention_nhd_seqq(q, k, v, scale)
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        o, lse = full_attention(q, k, v, ctx.scale)
        dq, dk, dv = _gqa_bwd(q, k, v, o, lse, do, ctx.scale, False)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: Optional[bool] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """The JAX dispatch unchanged: runs the kernel the JAX package would run
    on a TPU for these shapes, with its custom VJP.  q_offset: the causal
    query offset of K1, K5 and K6 (module docstring); a non-causal call
    takes none."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if causal is None:
        causal = T == S  # prefill
    if not causal and mask is not None:
        raise NotImplementedError("arbitrary masks use the plain sdpa path")
    if q_offset and not causal:
        raise ValueError("a query offset needs causal attention")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    name = select_kernel(T, S, Hq, Hkv, D, causal)
    if name in ("full_attention_nhd", "full_attention_nhd_seqq"):
        return _FlashFullNHD.apply(q, k, v, scale, name)
    return _FlashCore.apply(q, k, v, scale, causal, q_offset)
