"""The port's CUDA kernels against their plain versions, on the card, and
DecodeEngine's lockstep chunk replayed from a CUDA graph against the same
engine run eagerly.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py configures JAX.)  Tolerances: bf16 3e-2
(kernel and plain version round P and O to bf16, at running and final row
maxima), f32 1e-4 (summation order only), f32 lse 1e-3; K1's bf16 o at its
sm_90a body's tile edges row by row, within 2e-2 of each query's o norm.  Backward kernels
against their plain versions, row by row (each query's dQ, each key's dK
and dV), as chip_smoke.py holds them: bf16 within 2e-2 of the row's norm
(dQ, dK and dV are each rounded to bf16 once, from f32 sums taken in another
order over P and dS rounded at the same places), f32 within 1e-4 of it.  The
bf16 sm_90a kernels (K1-K6) are deterministic: two calls give the same
bits.
"""

import math

import numpy as np
import pytest
import torch

from tdc_video_tpu_torch.ops import flash_attention as tfa

pytestmark = pytest.mark.cuda

# (B, T, S, Hq, Hkv, D): ragged tiles everywhere; K1 with a cache longer than
# the query and GQA; K3 with D = 72 and H = 16
CASES = {
    "flash_kernel": (2, 145, 328, 4, 2, 128),
    "full_attention_nhd": (2, 145, 145, 4, 4, 64),
    "full_attention_nhd_seqq": (2, 145, 145, 16, 16, 72),
    "full_attention": (2, 145, 145, 4, 2, 72),  # K4: GQA, D = 72 padded to 80
}

# (B, T, Hq, Hkv, D, causal, packed) for K5/K6: the LM's causal GQA at D =
# 128 and both tower head dims, ragged tiles everywhere; then the sm_90a
# kernels' tile edges (128 query rows and 64 keys a block, 64-row tiles):
# T = 129, 200 and 1000, GQA groups 1, 3 and 7, D = 64, 72 (padded to 80)
# and 128, causal and not; packed: q, k, v are strided [B, T, H, D] views of
# packed [B, T, H * D] projections, as the towers pass them
BWD_CASES = [(1, 200, 6, 2, 128, True, False), (2, 145, 4, 4, 64, False, False),
             (2, 145, 4, 4, 72, False, False),
             (1, 129, 7, 1, 128, True, False), (1, 129, 3, 1, 64, False, False),
             (2, 200, 3, 3, 72, True, False), (1, 1000, 3, 1, 128, True, False),
             (1, 1000, 7, 1, 72, False, False), (2, 200, 4, 4, 72, False, True),
             (1, 1000, 4, 4, 64, True, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA kernels have no CPU mode")


def _qkv(seed, B, T, S, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    shapes = ((B, T, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    return tuple(torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to("cuda", dtype)
                 for s in shapes)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name, dtype, tol):
    B, T, S, Hq, Hkv, D = CASES[name]
    q, k, v = _qkv(6, B, T, S, Hq, Hkv, D, dtype)
    scale = 1 / math.sqrt(D)
    tfa.reset_launches()
    if name == "flash_kernel":
        out, lse = tfa.flash_kernel(q, k, v, scale, True)
        ref, lse_ref = tfa.flash_attention_plain(q, k, v, scale, True)
    elif name == "full_attention":
        out, lse = tfa.full_attention(q, k, v, scale)
        ref, lse_ref = tfa.full_attention_plain(q, k, v, scale)
    if name in ("flash_kernel", "full_attention"):
        torch.cuda.synchronize()
        assert float((lse - lse_ref).abs().max()) <= 1e-3
    else:
        out = getattr(tfa, name)(q, k, v, scale)
        ref = getattr(tfa, name + "_plain")(q, k, v, scale)
    torch.cuda.synchronize()
    assert tfa.launches[name] == 1
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= tol


def test_attention_dispatch_launches_on_card(cuda):
    """models/attention.py on CUDA tensors: T >= 128 maskless self-attention
    launches K2 (D = 64), causal launches K1, shorter calls go to sdpa."""
    from tdc_video_tpu_torch.models.attention import attention

    q, k, v = _qkv(8, 1, 145, 145, 4, 4, 64, torch.bfloat16)
    tfa.reset_launches()
    attention(q, k, v, impl="flash")
    attention(q, k, v, impl="flash", causal=True)
    attention(q[:, :100], k[:, :100], v[:, :100], impl="flash")
    assert tfa.launches == {"flash_kernel": 1, "full_attention_nhd": 1,
                            "full_attention_nhd_seqq": 0, "full_attention": 0,
                            "flash_dq_kernel": 0, "flash_dkv_kernel": 0}


def test_bf16_kernel_rejects_misaligned_operands(cuda):
    """The bf16 kernels load 16-byte chunks: an operand that starts off a
    16-byte boundary raises before any launch instead of running."""
    q, k, v = _qkv(7, 1, 130, 130, 4, 4, 64, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:].view(q.shape)
    shifted.copy_(q)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        tfa.full_attention_nhd(shifted, k, v, 0.125)
    assert tfa.launches["full_attention_nhd"] == 0


# (B, T, S, Hq, Hkv, D, causal) for K1's sm_90a forward body (128 query
# rows and 64 keys a block): T = 129, 200 and 1000, GQA groups 1, 3 and 7,
# D = 64, 72 (padded to 80) and 128; causal with S > T (top-left aligned, as
# a prefill into a longer cache) and with S == T; non-causal with T != S
FWD_CASES = [(1, 129, 129, 7, 1, 128, True), (2, 129, 200, 3, 1, 64, True),
             (1, 200, 264, 7, 1, 72, True), (2, 200, 200, 3, 3, 128, True),
             (1, 1000, 1016, 6, 2, 128, True), (1, 1000, 1000, 7, 1, 64, True),
             (1, 129, 300, 3, 1, 128, False), (2, 200, 145, 7, 1, 72, False),
             (1, 1000, 777, 3, 3, 64, False)]
# TDC-Qwen2-7B's GQA (28 query heads over 4 KV heads, group 7) at D = 128,
# causal into a longer cache, as the audio-visual prefill runs it
QWEN2_7B_CASE = (1, 1000, 1016, 28, 4, 128, True)


@pytest.mark.parametrize("case", FWD_CASES + [QWEN2_7B_CASE])
def test_k1_forward_tile_edges(cuda, case):
    """K1 in bf16 against its plain version: each query's o within 2e-2 of
    its row norm (as chip_smoke.py holds it), lse within 1e-3."""
    B, T, S, Hq, Hkv, D, causal = case
    q, k, v = _qkv(14, B, T, S, Hq, Hkv, D, torch.bfloat16)
    scale = 1 / math.sqrt(D)
    tfa.reset_launches()
    out, lse = tfa.flash_kernel(q, k, v, scale, causal)
    ref, lse_ref = tfa.flash_attention_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    assert tfa.launches["flash_kernel"] == 1
    _close(out, ref, 2e-2)
    assert float((lse - lse_ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("N", [145, 729])
def test_k3_forward_packed_views(cuda, N):
    """K3 in bf16 on [B, N, H, D] views of packed [B, N, H * D] projections
    (SigLIP, D = 72): within 3e-2 of its plain version."""
    B, H, D = 2, 16, 72
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, N, H * D)).astype(np.float32))
               .to("cuda", torch.bfloat16).view(B, N, H, D) for _ in range(3))
    tfa.reset_launches()
    out = tfa.full_attention_nhd_seqq(q, k, v, 1 / math.sqrt(D))
    ref = tfa.full_attention_nhd_seqq_plain(q, k, v, 1 / math.sqrt(D))
    torch.cuda.synchronize()
    assert tfa.launches["full_attention_nhd_seqq"] == 1
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= 3e-2


# (name, N, D) for K2 and K4 on packed [B, N, H * D] projections: the
# towers' N (729 and 730: 12 key tiles of 64, the last mostly padding), a
# short ragged N, and N a multiple of the 64- and 128-key tiles (640, 768),
# where no tile is ragged and a mask that assumed one would show
PACKED_CASES = [(name, N, D) for N in (145, 729, 730, 640, 768)
                for name, D in (("full_attention_nhd", 64), ("full_attention", 64),
                                ("full_attention", 72))]


@pytest.mark.parametrize("name,N,D", PACKED_CASES)
def test_k2_k4_forward_packed_views(cuda, name, N, D):
    """K2 and K4 in bf16 on [B, N, H, D] views of packed [B, N, H * D]
    projections: o within 3e-2 of the plain version, K4's lse within 1e-3
    on every row, and no row at or past N written (o is allocated by the
    wrapper, so a stray store would land in another row of it)."""
    B, H = 2, 24 if D == 64 else 16
    rng = np.random.default_rng(20 + N)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, N, H * D)).astype(np.float32))
               .to("cuda", torch.bfloat16).view(B, N, H, D) for _ in range(3))
    scale = 1 / math.sqrt(D)
    tfa.reset_launches()
    if name == "full_attention":
        out, lse = tfa.full_attention(q, k, v, scale)
        ref, lse_ref = tfa.full_attention_plain(q, k, v, scale)
    else:
        out = tfa.full_attention_nhd(q, k, v, scale)
        ref = tfa.full_attention_nhd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert tfa.launches[name] == 1
    assert out.shape == (B, N, H, D) and bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) <= 3e-2
    if name == "full_attention":
        assert lse.shape == (B, H, N, 1) and lse.dtype == torch.float32
        assert float((lse - lse_ref).abs().amax(dim=(0, 1, 3)).max()) <= 1e-3


def test_k4_forward_gqa(cuda):
    """K4 serves _gqa_fwd's non-causal T == S <= 1024 calls with Hq != Hkv:
    query head h reads KV head h / (Hq / Hkv), at both tower head dims."""
    for D in (64, 72):
        q, k, v = _qkv(21, 2, 730, 730, 12, 4, D, torch.bfloat16)
        out, lse = tfa.full_attention(q, k, v, 1 / math.sqrt(D))
        ref, lse_ref = tfa.full_attention_plain(q, k, v, 1 / math.sqrt(D))
        torch.cuda.synchronize()
        assert float((out.float() - ref.float()).abs().max()) <= 3e-2
        assert float((lse - lse_ref).abs().max()) <= 1e-3


def test_forward_kernels_deterministic(cuda):
    """K1-K4 sum in a fixed order: two calls give the same bits (K4's lse
    too)."""
    q, k, v = _qkv(16, 1, 1000, 1016, 6, 2, 128, torch.bfloat16)
    first, second = (tfa.flash_kernel(q, k, v, 0.088, True) for _ in range(2))
    p = _qkv(17, 2, 729, 729, 16, 16, 72, torch.bfloat16)
    third, fourth = (tfa.full_attention_nhd_seqq(*p, 0.118) for _ in range(2))
    d = _qkv(19, 2, 730, 730, 24, 24, 64, torch.bfloat16)
    fifth, sixth = (tfa.full_attention_nhd(*d, 0.125) for _ in range(2))
    k4 = [tfa.full_attention(*x, s) for x, s in ((d, 0.125), (p, 0.118)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(third, fourth)
    assert torch.equal(fifth, sixth)
    for a, b in (k4[:2], k4[2:]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", ["flash_kernel", "full_attention_nhd", "full_attention_nhd_seqq",
                                  "full_attention"])
def test_sm90_forward_rejects_misaligned_operands(cuda, name):
    """K1-K4 read through TMA tensor maps: an operand that starts off a
    16-byte boundary raises before any launch instead of running."""
    D = {"flash_kernel": 128, "full_attention_nhd": 64}.get(name, 72)
    q, k, v = _qkv(18, 1, 145, 145, 4, 4, D, torch.bfloat16)
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device="cuda")[1:].view(k.shape)
    shifted.copy_(k)
    tfa.reset_launches()
    with pytest.raises(ValueError, match="aligned"):
        if name == "flash_kernel":
            tfa.flash_kernel(q, shifted, v, 0.088, True)
        else:
            getattr(tfa, name)(q, shifted, v, 1 / math.sqrt(D))
    assert tfa.launches[name] == 0


def _bwd_inputs(seed, B, T, Hq, Hkv, D, causal, dtype, valid=None, packed=False):
    """q, k, v, dO and the plain forward's o, lse and delta; dO rows at or
    past `valid` are zero (right padding).  packed: q, k and v are [B, T, H,
    D] views of [B, T, H * D] tensors (Hq == Hkv)."""
    q, k, v = _qkv(seed, B, T, T, Hq, Hkv, D, dtype)
    if packed:
        q, k, v = (x.reshape(B, T, Hq * D).view(B, T, Hq, D) for x in (q, k, v))
    do = _qkv(seed + 1, B, T, T, Hq, Hq, D, dtype)[0]
    if valid is not None:
        do[:, valid:] = 0
    o, lse = tfa.flash_attention_plain(q, k, v, 1 / math.sqrt(D), causal)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    return q, k, v, do, lse, delta


def _close(out, ref, rel):
    """Each row (last dim) of out within rel of the reference row's norm,
    floored at a tenth of the RMS row norm, as chip_smoke._compare_rows."""
    assert bool(torch.isfinite(out).all())
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    norm = r.norm(dim=-1)
    floor = max(0.1 * float(norm.square().mean().sqrt()), 1e-30)
    assert float(((o - r).norm(dim=-1) / norm.clamp_min(floor)).max()) <= rel


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernels_match_plain(cuda, case, dtype, rel):
    B, T, Hq, Hkv, D, causal, packed = case
    args = _bwd_inputs(9, B, T, Hq, Hkv, D, causal, dtype, packed=packed)
    scale = 1 / math.sqrt(D)
    tfa.reset_launches()
    dq = tfa.flash_dq_kernel(*args, scale, causal)
    dk, dv = tfa.flash_dkv_kernel(*args, scale, causal)
    dq_ref = tfa.flash_dq_plain(*args, scale, causal)
    dk_ref, dv_ref = tfa.flash_dkv_plain(*args, scale, causal)
    torch.cuda.synchronize()
    assert tfa.launches["flash_dq_kernel"] == 1 and tfa.launches["flash_dkv_kernel"] == 1
    _close(dq, dq_ref, rel)
    _close(dk, dk_ref, rel)
    _close(dv, dv_ref, rel)


@pytest.mark.parametrize("case", [(1, 1000, 6, 2, 128, True, False), (2, 200, 4, 4, 72, False, True)])
def test_backward_kernels_deterministic(cuda, case):
    """No atomics and a fixed order of sums: two calls on the same inputs
    give bitwise-equal dQ, dK and dV."""
    B, T, Hq, Hkv, D, causal, packed = case
    args = _bwd_inputs(13, B, T, Hq, Hkv, D, causal, torch.bfloat16, packed=packed)
    scale = 1 / math.sqrt(D)
    first = (tfa.flash_dq_kernel(*args, scale, causal), *tfa.flash_dkv_kernel(*args, scale, causal))
    second = (tfa.flash_dq_kernel(*args, scale, causal), *tfa.flash_dkv_kernel(*args, scale, causal))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_padded_rows_zero_dq_and_no_dkv(cuda, dtype):
    """Rows whose dO is zero get exactly zero dQ and add nothing to dK/dV:
    the kernels' dK/dV equal those of the valid rows alone."""
    B, T, H, D, valid = 1, 200, 2, 64, 150
    q, k, v, do, lse, delta = _bwd_inputs(10, B, T, H, H, D, True, dtype, valid=valid)
    scale = 1 / math.sqrt(D)
    dq = tfa.flash_dq_kernel(q, k, v, do, lse, delta, scale, True)
    dk, dv = tfa.flash_dkv_kernel(q, k, v, do, lse, delta, scale, True)
    part = [t[:, :valid].contiguous() for t in (q, k, v, do)]
    sub = [t[:, :, :valid].contiguous() for t in (lse, delta)]
    dk_v, dv_v = tfa.flash_dkv_kernel(*part, *sub, scale, True)
    torch.cuda.synchronize()
    assert float(dq[:, valid:].abs().max()) == 0.0
    assert float(dk[:, valid:].abs().max()) == 0.0 and float(dv[:, valid:].abs().max()) == 0.0
    assert torch.equal(dk[:, :valid], dk_v) and torch.equal(dv[:, :valid], dv_v)


@pytest.mark.parametrize("causal,shape", [(True, (1, 256, 6, 2, 128)), (False, (2, 145, 4, 4, 64)),
                                          (False, (2, 145, 16, 16, 72)), (False, (2, 145, 4, 2, 64))])
def test_attention_flash_gradients_on_card(cuda, causal, shape):
    """attention(impl="flash") on CUDA tensors carries gradients through the
    kernels (K1/K4 or K2/K3 forward, K5 and K6 backward), and they equal the
    same function's gradients through the plain versions on the CPU (f32)."""
    from tdc_video_tpu_torch.models.attention import attention

    B, T, Hq, Hkv, D = shape
    q, k, v = _qkv(11, B, T, T, Hq, Hkv, D, torch.float32)
    w = _qkv(12, B, T, T, Hq, Hq, D, torch.float32)[0]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        tfa.reset_launches()
        if dev == "cuda":
            o = attention(*leaves, impl="flash", causal=causal)
        else:  # the CPU dispatch goes to sdpa; call the kernels' plain path
            o = tfa.flash_attention(*leaves, causal=causal)
        (o * w.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
        if dev == "cuda":
            assert tfa.launches["flash_dq_kernel"] == 1 and tfa.launches["flash_dkv_kernel"] == 1
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("shape", [((1, 1, 3584), (3584, 8192)), ((2, 5, 8, 64), (2, 5, 64, 40)),
                                   ((2, 4, 3, 7, 128), (2, 4, 1, 128, 33))],
                         ids=["head", "batched", "gqa_fold"])
def test_dot_f32_on_card(cuda, shape):
    """layers.dot_f32 on CUDA runs the bf16 operands' GEMM with f32
    accumulation and output: against an f64 product of the same bf16
    values within f32 summation error (1e-5 of sum |a||b|), and gradients
    against the f64 ones within bf16 rounding (1e-2 of their max)."""
    from tdc_video_tpu_torch.models.layers import dot_f32

    g = torch.Generator().manual_seed(5)
    a, b = (torch.randn(s, generator=g).to(torch.bfloat16) for s in shape)
    ad, bd = (x.cuda().requires_grad_() for x in (a, b))
    y = dot_f32(ad, bd)
    assert y.dtype == torch.float32 and y.device.type == "cuda"
    ref = a.double() @ b.double()
    scale = (a.double().abs() @ b.double().abs())
    assert float(((y.detach().cpu().double() - ref).abs() / scale.clamp_min(1e-30)).max()) <= 1e-5
    w = torch.randn(ref.shape, generator=g)
    (y * w.cuda()).sum().backward()
    a64, b64 = (x.double().requires_grad_() for x in (a, b))
    ((a64 @ b64) * w.double()).sum().backward()
    for got, want in ((ad.grad, a64.grad), (bd.grad, b64.grad)):
        assert got.dtype == torch.bfloat16
        want = want.sum_to_size(got.shape) if want.shape != got.shape else want
        assert float((got.cpu().double() - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_dot_f32_makes_no_f32_copy(cuda):
    """The head product of a 1-token decode step allocates its f32 output
    and no f32 copy of the [3584, 152064] bf16 weight (2.18 GB)."""
    from tdc_video_tpu_torch.models.layers import dot_f32

    h = torch.randn((1, 1, 3584), device="cuda").to(torch.bfloat16)
    w = torch.randn((3584, 152064), device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = dot_f32(h, w)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert y.dtype == torch.float32
    assert extra < 64 * 2**20, extra  # output 0.6 MB + workspace; an f32 copy is 2.18 GB


def test_dot_f32_master_gradient_in_f32(cuda):
    """A weight cast once for several products (lm.lm_loss's chunks) gets
    its gradient, accumulated over the products, in its own f32 dtype."""
    from tdc_video_tpu_torch.models.layers import dot_f32

    g = torch.Generator().manual_seed(6)
    master = torch.randn((64, 96), generator=g).cuda().requires_grad_()
    w = master.to(torch.bfloat16)
    hs = [torch.randn((5, 64), generator=g).cuda().to(torch.bfloat16) for _ in range(3)]
    sum(dot_f32(h, w, master).sum() for h in hs).backward()
    want = sum(h.double().sum(0)[:, None].expand(64, 96) for h in hs)
    assert master.grad.dtype == torch.float32
    assert float((master.grad.double() - want).abs().max()) <= 1e-2 * float(want.abs().max())


def test_int8_dot_on_card_exact(cuda):
    """layers.int8_dot on CUDA (torch._int_mm with rows, K and N padded as it
    needs: 5 rows, K = 588 as the towers' patch embedding, N = 36) gives the
    CPU's exact s32 product, in both weight layouts."""
    from tdc_video_tpu_torch.models import layers

    g = torch.Generator().manual_seed(7)
    x = torch.randint(-127, 128, (5, 588), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (588, 36), generator=g, dtype=torch.int8)
    ref = layers._int_mm(x, w)
    for wd in (w.cuda(), w.t().contiguous().t().cuda()):
        out = layers._int_mm(x.cuda(), wd)
        assert torch.equal(out.cpu(), ref)
    p = {"w_q": w, "w_scale": torch.rand(36, generator=g)}
    xs = torch.rand((5, 1), generator=g)
    pc = {k: v.cuda() for k, v in p.items()}
    out = layers.int8_dot(x.cuda(), xs.cuda(), pc, torch.float32)
    assert torch.allclose(out.cpu(), layers.int8_dot(x, xs, p, torch.float32), rtol=1e-6, atol=0)


def test_sdpa_int8kv_on_card(cuda):
    """Attention over an int8 KV cache on the card against the CPU's, f32 and
    bf16 queries (bf16: 3e-2, as the kernels' bf16 tolerance)."""
    from tdc_video_tpu_torch.models.layers import sdpa_int8kv

    g = torch.Generator().manual_seed(8)
    B, T, S, Hq, Hkv, D = 2, 3, 40, 8, 2, 64
    q = torch.randn((B, T, Hq, D), generator=g)
    kq, vq = (torch.randint(-127, 128, (B, S, Hkv, D), generator=g, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((B, S, Hkv), generator=g) / 100 for _ in range(2))
    mask = (torch.arange(S)[None] < torch.tensor([[S], [S - 7]]))[:, None, None, :]
    ref = sdpa_int8kv(q, kq, ks, vq, vs, mask)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 3e-2)):
        out = sdpa_int8kv(*(t.cuda() for t in (q.to(dtype), kq, ks, vq, vs, mask)))
        err = float((out.float().cpu() - ref).abs().max())
        assert err <= tol * max(1.0, float(ref.abs().max()))


def test_sample_rows_card_equals_cpu(cuda):
    """The engine's sampler on the card: the threefry bits of every row's
    counter-mode key bitwise equal to the CPU's at the Llama-3 vocabulary
    (128,256 lanes a row), and the same tokens from the same logits, greedy
    and sampled rows mixed."""
    from tdc_video_tpu_torch.serving import generate as tgen
    from tdc_video_tpu_torch.serving import prng

    rng = np.random.default_rng(0)
    V = 128256
    x = torch.from_numpy(rng.normal(0, 2, (4, V)).astype(np.float32))
    rows = (torch.tensor([0.0, 0.2, 1.0, 0.7]), torch.tensor([50, 50, 0, 20], dtype=torch.int32),
            torch.tensor([1.0, 1.0, 0.9, 0.8]), torch.tensor([0, 1, 2, 3], dtype=torch.int32),
            torch.tensor([0, 5, 17, 2], dtype=torch.int32))
    keys = tgen.row_keys(rows[3], rows[4])
    assert torch.equal(tgen.row_keys(rows[3].cuda(), rows[4].cuda()).cpu(), keys)
    assert torch.equal(prng.random_bits(keys.cuda(), (V,)).cpu(), prng.random_bits(keys, (V,)))
    assert torch.equal(prng.uniform(keys.cuda(), (V,)).cpu(), prng.uniform(keys, (V,)))
    ref = tgen.sample_rows(x, *rows)
    out = tgen.sample_rows(x.cuda(), *(r.cuda() for r in rows))
    assert torch.equal(out.cpu(), ref)


# Causal query offset (K1, K5, K6; sequence parallelism): (B, T, S, Hq, Hkv,
# D, q_offset).  A tile-aligned block of the sequence (the 2-way split's
# second rank), the first rank's block (offset 0, keys past T unseen), an
# offset off the 64-key tiles (two masked tiles a warpgroup), D = 64 and 72,
# and a ragged last block that ends at S
OFFSET_CASES = [(1, 256, 512, 6, 2, 128, 256), (1, 256, 512, 6, 2, 128, 0),
                (1, 200, 600, 7, 1, 128, 333), (2, 129, 400, 3, 1, 64, 100),
                (1, 145, 328, 4, 2, 72, 183)]


def _offset_bwd_inputs(seed, B, T, S, Hq, Hkv, D, q_offset, dtype):
    """q, k, v, dO and the plain forward's lse and delta at the offset."""
    q, k, v = _qkv(seed, B, T, S, Hq, Hkv, D, dtype)
    do = _qkv(seed + 1, B, T, S, Hq, Hq, D, dtype)[0]
    o, lse = tfa.flash_attention_plain(q, k, v, 1 / math.sqrt(D), True, q_offset)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("dtype,rel", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", OFFSET_CASES)
def test_offset_kernels_match_plain(cuda, case, dtype, rel):
    """K1, K5 and K6 at a causal query offset against their plain versions
    at the same offset: each query's o and dQ, each key's dK and dV, within
    rel of its row norm; lse within 1e-3 (f32: 1e-4)."""
    B, T, S, Hq, Hkv, D, off = case
    args = _offset_bwd_inputs(21, B, T, S, Hq, Hkv, D, off, dtype)
    q, k, v = args[:3]
    scale = 1 / math.sqrt(D)
    tfa.reset_launches()
    out, lse = tfa.flash_kernel(q, k, v, scale, True, q_offset=off)
    ref, lse_ref = tfa.flash_attention_plain(q, k, v, scale, True, off)
    dq = tfa.flash_dq_kernel(*args, scale, True, q_offset=off)
    dk, dv = tfa.flash_dkv_kernel(*args, scale, True, q_offset=off)
    dq_ref = tfa.flash_dq_plain(*args, scale, True, off)
    dk_ref, dv_ref = tfa.flash_dkv_plain(*args, scale, True, off)
    torch.cuda.synchronize()
    assert [tfa.launches[n] for n in ("flash_kernel", "flash_dq_kernel", "flash_dkv_kernel")] == [1, 1, 1]
    assert float((lse - lse_ref).abs().max()) <= (1e-3 if dtype == torch.bfloat16 else 1e-4)
    for got, want in ((out, ref), (dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        _close(got, want, rel)


@pytest.mark.parametrize("off", [256, 448])
def test_k1_offset_block_is_whole_call_rows(cuda, off):
    """A block of queries at a 64-aligned offset gives the rows of a K1 call
    over the whole sequence bit for bit (o and lse): each warpgroup sees the
    same tiles under the same masks."""
    B, S, Hq, Hkv, D, T = 1, 1024, 6, 2, 128, 256
    q, k, v = _qkv(22, B, S, S, Hq, Hkv, D, torch.bfloat16)
    scale = 1 / math.sqrt(D)
    o, lse = tfa.flash_kernel(q, k, v, scale, True)
    ob, lb = tfa.flash_kernel(q[:, off:off + T], k, v, scale, True, q_offset=off)
    torch.cuda.synchronize()
    assert torch.equal(ob, o[:, off:off + T]) and torch.equal(lb, lse[:, :, off:off + T])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_offset_unseen_keys_written_zero(cuda, dtype):
    """Keys past the block's last diagonal (q_offset + T - 1) meet no query:
    K6 writes them as exact zeros into outputs whose memory held NaN just
    before (the caching allocator hands the same block back), so a rank's
    partial dK and dV may be summed."""
    B, T, S, Hq, Hkv, D, off = 1, 256, 1024, 6, 2, 128, 256
    args = _offset_bwd_inputs(23, B, T, S, Hq, Hkv, D, off, dtype)
    scale = 1 / math.sqrt(D)
    poison = [torch.full((B, S, Hkv, D), float("nan"), dtype=dtype, device="cuda") for _ in range(2)]
    del poison
    dk, dv = tfa.flash_dkv_kernel(*args, scale, True, q_offset=off)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dk).all()) and bool(torch.isfinite(dv).all())
    assert float(dk[:, off + T:].abs().max()) == 0.0 and float(dv[:, off + T:].abs().max()) == 0.0
    assert float(dv[:, :off + T].abs().max()) > 0.0


def test_offset_blocks_sum_to_whole_backward(cuda):
    """f32: dQ of each block is the whole call's rows, and the blocks' dK and
    dV (each rank's partial) sum to the whole call's, within 1e-4 of each
    key's norm."""
    B, S, Hq, Hkv, D, n = 1, 512, 6, 2, 128, 4
    q, k, v, do, lse, delta = _offset_bwd_inputs(24, B, S, S, Hq, Hkv, D, 0, torch.float32)
    scale = 1 / math.sqrt(D)
    dq = tfa.flash_dq_kernel(q, k, v, do, lse, delta, scale, True)
    dk, dv = tfa.flash_dkv_kernel(q, k, v, do, lse, delta, scale, True)
    w = S // n
    dks, dvs = torch.zeros_like(dk), torch.zeros_like(dv)
    for c in range(n):
        r = slice(c * w, (c + 1) * w)
        part = (q[:, r], k, v, do[:, r], lse[:, :, r].contiguous(), delta[:, :, r].contiguous())
        _close(tfa.flash_dq_kernel(*part, scale, True, q_offset=c * w), dq[:, r], 1e-4)
        a, b = tfa.flash_dkv_kernel(*part, scale, True, q_offset=c * w)
        dks, dvs = dks + a, dvs + b
    torch.cuda.synchronize()
    _close(dks, dk, 1e-4)
    _close(dvs, dv, 1e-4)


# DecodeEngine's lockstep chunk replayed from a CUDA graph (serving/batching.py)
# against the same engine run eagerly on the card: a small bf16 Qwen2-style
# LM (GQA, q/k/v biases) whose decode products go through cuBLAS


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _engine_model():
    import dataclasses

    from tdc_video_tpu_torch import config as tc
    from tdc_video_tpu_torch.models import lm as tlm

    cfg = tc.tdc_tiny()
    lm = dataclasses.replace(cfg.lm, vocab_size=4096, hidden_size=512, num_layers=4, num_heads=8,
                             num_kv_heads=2, head_dim=64, intermediate_size=1408)
    cfg = dataclasses.replace(cfg, lm=lm, dtype=torch.bfloat16)
    params = tlm.init_lm(lm, torch.Generator().manual_seed(0), device="cpu", dtype=torch.bfloat16)
    return cfg, {"lm": _tree_to(params, "cuda")}


def _engine_group(eng, cfg, params, seed, sampled):
    """Two requests, a third submitted from the first harvest and the second
    cancelled there; returns {uid: (tokens, cancelled)}."""
    from tdc_video_tpu_torch.models import lm as tlm
    from tdc_video_tpu_torch.serving.batching import Request

    rng = np.random.default_rng(seed)

    def req(uid, n, i):
        ids = torch.from_numpy(rng.integers(2, cfg.lm.vocab_size, (1, n))).to(eng.device)
        kw = dict(temperature=[0.8, 1.2, 0.0][i], top_k=[40, 0, 0][i], top_p=[1.0, 0.9, 1.0][i],
                  seed=seed + i) if sampled else {}
        return Request(embeds=tlm.embed_tokens(cfg.lm, params["lm"], ids, cfg.dtype),
                       attn_mask=np.ones((1, n), bool), max_new_tokens=24, uid=uid, **kw)

    hooked = {"done": False}

    def on_tokens(r, new):
        if r.uid == "a" and len(r.tokens) >= 5 and not hooked["done"]:
            hooked["done"] = True
            eng.submit(req("c", 11, 2))
            assert eng.cancel("b")

    eng.on_tokens = on_tokens
    eng.submit(req("a", 17, 0))
    eng.submit(req("b", 9, 1))
    done = {r.uid: (list(r.tokens), r.cancelled) for r in eng.run()}
    assert hooked["done"] and done["b"][1]
    return done


def _logit_recorder(eng):
    """Each step's logits into a buffer the chunk writes (captured with it on
    the graphed engine), copied out at each harvest."""
    buf = torch.zeros((eng.chunk_tokens, eng.num_slots, eng.cfg.lm.vocab_size),
                      dtype=torch.float32, device="cuda")
    step, harvest, seen, chunks = eng._step, eng._harvest_state, [0], []

    def rec_step(tok, active):
        logits = step(tok, active)
        buf[seen[0] % eng.chunk_tokens].copy_(logits)
        seen[0] += 1
        return logits

    def rec_harvest(*outs):
        chunks.append(buf.clone())
        return harvest(*outs)

    eng._step, eng._harvest_state = rec_step, rec_harvest
    return chunks


@pytest.mark.parametrize("kv,sampled", [(None, (False, False)), (None, (True, False)),
                                        ("int8", (False, True))],
                         ids=["greedy", "sampled_then_greedy", "int8_kv"])
def test_engine_chunk_graph_bitwise_eager(cuda, kv, sampled):
    """Two groups (reset between) with admission and cancellation between
    chunks: every step's logits, every token and the whole KV cache of the
    graphed engine bitwise equal to the eager one's; one capture per variant
    used, every later chunk a replay."""
    from tdc_video_tpu_torch.serving.batching import DecodeEngine

    cfg, params = _engine_model()
    engines, logits, tokens = [], [], []
    for graphed in (True, False):
        eng = DecodeEngine(cfg, params, num_slots=2, capacity=128, chunk_tokens=4, kv_quant=kv,
                           device="cuda")
        if not graphed:
            eng._graphs = None  # the eager path on the card
        chunks = _logit_recorder(eng)
        got, steps = [], 0
        for g, s in enumerate(sampled):
            if g:
                eng.reset()
            got.append(_engine_group(eng, cfg, params, 7 + g, s))
            steps += eng.steps
        torch.cuda.synchronize()
        engines.append((eng, steps))
        logits.append(chunks)
        tokens.append(got)
    (geng, gsteps), (eeng, esteps) = engines
    assert tokens[0] == tokens[1] and gsteps == esteps == len(logits[0]) == len(logits[1])
    for i, (a, b) in enumerate(zip(*logits)):
        assert torch.equal(a, b), f"chunk {i}: logits differ by {float((a - b).abs().max())}"
    for k in geng.cache:
        assert torch.equal(geng.cache[k], eeng.cache[k]), k
    assert set(geng._graphs) == set(sampled) and geng.graph_captures == len(set(sampled))
    assert geng.graph_replays == gsteps - geng.graph_captures > 0
    assert eeng.graph_captures == eeng.graph_replays == 0


def test_engine_graphs_only_plain_card_chunks(cuda):
    """A speculative engine on the card and an engine on the CPU run every
    chunk eagerly and never capture."""
    from tdc_video_tpu_torch.serving.batching import DecodeEngine

    cfg, params = _engine_model()
    spec = DecodeEngine(cfg, params, num_slots=2, capacity=128, chunk_tokens=4, spec_window=3,
                        device="cuda")
    assert spec._graphs is None
    _engine_group(spec, cfg, params, 3, False)
    cpu_params = _tree_to(params, "cpu")
    cpu = DecodeEngine(cfg, cpu_params, num_slots=2, capacity=128, chunk_tokens=4, device="cpu")
    assert cpu._graphs is None
    _engine_group(cpu, cfg, cpu_params, 3, False)
    for eng in (spec, cpu):
        assert eng.steps > 0 and eng.graph_captures == eng.graph_replays == 0
