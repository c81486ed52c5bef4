"""The host side of the sm_90a kernels (the forward body of K1-K4, the
backward kernels K5 and K6), on the CPU: the 4-D TMA tensor map each builds
over a bf16 operand [B, L, H, D] (ops/flash_attention.py tma_operand) and
the element strides the launch passes for it (operand_strides, and
fwd_operand_strides for the forward kernels), which csrc/sm90.cuh make_map
uses as they are, for the layouts the port passes: contiguous q/k/v/dO, the
packed [B, N, H * D] tower projections viewed as [B, N, H, D], a layer's
view of the stacked KV cache, and views with dims of size 1."""

import pytest
import torch

from tdc_video_tpu_torch.ops.flash_attention import (fwd_operand_strides, operand_strides,
                                                     tma_operand)


def _launch_strides_match_map(t, byte_strides):
    """The (batch, row, head) strides of the launch are the map's, in elements."""
    sh, sl, sb = byte_strides
    assert operand_strides(t) == (sb // 2, sl // 2, sh // 2)


def test_contiguous_operand():
    t = torch.zeros(2, 145, 4, 64, dtype=torch.bfloat16)
    dims, strides = tma_operand(t)
    assert dims == (64, 4, 145, 2)
    assert strides == (64 * 2, 4 * 64 * 2, 145 * 4 * 64 * 2)
    _launch_strides_match_map(t, strides)
    assert operand_strides(t) == t.stride()[:3]


@pytest.mark.parametrize("H,D", [(16, 72), (24, 64)])
def test_packed_tower_projection(H, D):
    """A head's D columns are followed by the next head's: the map's
    innermost extent is D (TMA fills the columns past it with zeros), and
    the head stride is D elements, not the padded width."""
    packed = torch.zeros(2, 729, H * D, dtype=torch.bfloat16)
    dims, strides = tma_operand(packed.view(2, 729, H, D))
    assert dims == (D, H, 729, 2)
    assert strides == (D * 2, H * D * 2, 729 * H * D * 2)
    _launch_strides_match_map(packed.view(2, 729, H, D), strides)


def test_size_one_dims_take_packed_strides():
    """One KV head sliced out of eight, batch 1: the stride of a size-1 dim
    is never used, so the map, and the launch, get the packed stride there."""
    k = torch.zeros(1, 200, 8, 128, dtype=torch.bfloat16)[:, :, 3:4]
    assert k.stride() == (200 * 8 * 128, 8 * 128, 128, 1)
    dims, strides = tma_operand(k)
    assert dims == (128, 1, 200, 1)
    assert strides == (128 * 2, 8 * 128 * 2, 8 * 128 * 2 * 200)
    _launch_strides_match_map(k, strides)
    assert operand_strides(k) == (8 * 128 * 200, 8 * 128, 128)


def test_size_one_dim_with_zero_stride():
    """A batch of 1 with batch stride 0: the launch passes the packed batch
    stride, which a tensor map accepts, not 0."""
    t = torch.zeros(145 * 4 * 64, dtype=torch.bfloat16).as_strided((1, 145, 4, 64), (0, 256, 64, 1))
    dims, strides = tma_operand(t)
    assert strides[2] == 145 * 4 * 64 * 2
    assert operand_strides(t) == (145 * 4 * 64, 4 * 64, 64)


def test_f32_operands_pass_their_own_strides():
    """The f32 kernels index through plain strides: no tensor map."""
    t = torch.zeros(2, 30, 8, 16, dtype=torch.float32)[:, :, 3:4]
    assert operand_strides(t) == t.stride()[:3]


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 145, 4, 64, dtype=torch.bfloat16).expand(2, 145, 4, 64),  # batch stride 0
    lambda: torch.zeros(2, 145, 4, 60, dtype=torch.bfloat16),  # 120-byte head stride
])
def test_operands_a_map_cannot_describe_raise(make):
    with pytest.raises(ValueError, match="TMA"):
        tma_operand(make())
    with pytest.raises(ValueError, match="TMA"):
        operand_strides(make())


# ---------------------------------------------------------------------------
# The forward kernels' operands (K1-K4, all through tensor maps)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 2])
def test_k1_reads_a_layer_of_the_stacked_kv_cache(B):
    """Serving prefills T rows into layer i's view cache["k"][i] of the
    stacked [L, B, S, Hkv, D] cache (models/lm.py), S > T: the map's row
    extent is the cache capacity S, its base the layer's slice, and the
    launch passes the view's strides (the packed ones where B == 1)."""
    L, S, T, Hkv, Hq, D = 3, 1432, 1416, 8, 24, 128
    cache = torch.zeros(L, B, S, Hkv, D, dtype=torch.bfloat16)
    k, v = cache[1], cache[2]
    q = torch.zeros(B, T, Hq, D, dtype=torch.bfloat16)
    assert k.data_ptr() - cache.data_ptr() == B * S * Hkv * D * 2  # a multiple of 16 bytes
    dims, strides = tma_operand(k)
    assert dims == (D, Hkv, S, B)
    assert strides == (D * 2, Hkv * D * 2, S * Hkv * D * 2)
    kv = (S * Hkv * D, Hkv * D, D)
    assert fwd_operand_strides("flash_kernel", q, k, v) == (T * Hq * D, Hq * D, D) + kv + kv


def test_k3_reads_the_packed_tower_projections():
    """SigLIP's q, k and v are [B, N, H * D] projections viewed as [B, N, H,
    D] (models/vit.py): K3's maps step D = 72 elements from head to head."""
    B, N, H, D = 2, 729, 16, 72
    q, k, v = (torch.zeros(B, N, H * D, dtype=torch.bfloat16).view(B, N, H, D) for _ in range(3))
    assert fwd_operand_strides("full_attention_nhd_seqq", q, k, v) == (N * H * D, H * D, D) * 3


def test_k1_size_one_head_takes_the_packed_stride():
    """One KV head sliced out of a wider projection, batch 1: K1 passes the
    map's packed strides for the size-1 dims, and so does K4, whose bf16
    body reads through tensor maps too (before, K4 took the tensor's own)."""
    q = torch.zeros(1, 200, 3, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 200, 8, 128, dtype=torch.bfloat16)[:, :, 3:4]
    st = fwd_operand_strides("flash_kernel", q, k, k)
    assert st[3:6] == (8 * 128 * 200, 8 * 128, 128)
    assert fwd_operand_strides("full_attention", q, k, k) == st


def test_f32_forward_operands_pass_their_own_strides():
    """f32 calls of K1 and K3 take the scalar kernel: no tensor map."""
    q = torch.zeros(2, 30, 8, 16, dtype=torch.float32)[:, :, 2:6]
    assert fwd_operand_strides("flash_kernel", q, q, q) == q.stride()[:3] * 3


@pytest.mark.parametrize("name", ["flash_kernel", "full_attention_nhd", "full_attention_nhd_seqq",
                                  "full_attention"])
def test_forward_operands_a_map_cannot_describe_raise(name):
    """Every forward kernel (K1-K4) raises before any launch on a bf16
    operand that a tensor map cannot describe: a batch broadcast with stride
    0, or a head stride off a 16-byte multiple.  K2, which read through
    cp.async before its bf16 body moved to the sm_90a template, took a
    stride-0 batch as it was; it raises now too."""
    q = torch.zeros(2, 145, 4, 72, dtype=torch.bfloat16)
    k = torch.zeros(1, 145, 4, 72, dtype=torch.bfloat16).expand(2, 145, 4, 72)
    with pytest.raises(ValueError, match="TMA"):
        fwd_operand_strides(name, q, k, q)
    odd = torch.zeros(2, 145, 4, 76, dtype=torch.bfloat16)[..., :72]  # 152-byte head stride
    with pytest.raises(ValueError, match="TMA"):
        fwd_operand_strides(name, q, q, odd)


def test_forward_strides_reject_a_backward_kernel():
    """The forward rule is asked only for a forward kernel: K5 passes its
    operands' strides through operand_strides in the backward launch."""
    q = torch.zeros(2, 145, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not an sm_90a forward kernel"):
        fwd_operand_strides("flash_dq_kernel", q, q, q)


@pytest.mark.parametrize("H,D", [(24, 64), (16, 72)])
def test_k4_reads_the_packed_tower_projections(H, D):
    """K4 recomputes the tower attention in the backward on the same packed
    [B, N, H * D] projections K2 and K3 read (DINOv2 D = 64, SigLIP D = 72):
    its maps step D elements from head to head (not the padded 64 or 80),
    N * H * D from frame to frame."""
    B, N = 8, 730 if D == 64 else 729
    q, k, v = (torch.zeros(B, N, H * D, dtype=torch.bfloat16).view(B, N, H, D) for _ in range(3))
    assert tma_operand(q)[0] == (D, H, N, B)
    assert fwd_operand_strides("full_attention", q, k, v) == (N * H * D, H * D, D) * 3
    assert fwd_operand_strides("full_attention_nhd", q, k, v) == (N * H * D, H * D, D) * 3
