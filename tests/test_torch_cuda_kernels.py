"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them.  The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest -q

(--noconftest: tests/conftest.py configures JAX.)  Tolerances: bf16 3e-2
(kernel and plain version round P and O to bf16, at running and final row
maxima), f32 1e-4 (summation order only), f32 lse 1e-3.
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
}


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
                            "full_attention_nhd_seqq": 0}


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
