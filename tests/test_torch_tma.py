"""The host side of the sm_90a backward kernels K5 and K6, on the CPU: the
4-D TMA tensor map each builds over a bf16 operand [B, L, H, D]
(ops/flash_attention.py tma_operand) and the element strides the launch
passes for it (bwd_operand_strides), which csrc/sm90.cuh make_map uses as
they are, for the layouts the port passes: contiguous q/k/v/dO, the packed
[B, N, H * D] tower projections viewed as [B, N, H, D], and views with dims
of size 1."""

import pytest
import torch

from tdc_video_tpu_torch.ops.flash_attention import bwd_operand_strides, tma_operand


def _launch_strides_match_map(t, byte_strides):
    """The (batch, row, head) strides of the launch are the map's, in elements."""
    sh, sl, sb = byte_strides
    assert bwd_operand_strides(t) == (sb // 2, sl // 2, sh // 2)


def test_contiguous_operand():
    t = torch.zeros(2, 145, 4, 64, dtype=torch.bfloat16)
    dims, strides = tma_operand(t)
    assert dims == (64, 4, 145, 2)
    assert strides == (64 * 2, 4 * 64 * 2, 145 * 4 * 64 * 2)
    _launch_strides_match_map(t, strides)
    assert bwd_operand_strides(t) == t.stride()[:3]


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
    assert bwd_operand_strides(k) == (8 * 128 * 200, 8 * 128, 128)


def test_size_one_dim_with_zero_stride():
    """A batch of 1 with batch stride 0: the launch passes the packed batch
    stride, which a tensor map accepts, not 0."""
    t = torch.zeros(145 * 4 * 64, dtype=torch.bfloat16).as_strided((1, 145, 4, 64), (0, 256, 64, 1))
    dims, strides = tma_operand(t)
    assert strides[2] == 145 * 4 * 64 * 2
    assert bwd_operand_strides(t) == (145 * 4 * 64, 4 * 64, 64)


def test_f32_operands_pass_their_own_strides():
    """The f32 kernels index through plain strides: no tensor map."""
    t = torch.zeros(2, 30, 8, 16, dtype=torch.float32)[:, :, 3:4]
    assert bwd_operand_strides(t) == t.stride()[:3]


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 145, 4, 64, dtype=torch.bfloat16).expand(2, 145, 4, 64),  # batch stride 0
    lambda: torch.zeros(2, 145, 4, 60, dtype=torch.bfloat16),  # 120-byte head stride
])
def test_operands_a_map_cannot_describe_raise(make):
    with pytest.raises(ValueError, match="TMA"):
        tma_operand(make())
    with pytest.raises(ValueError, match="TMA"):
        bwd_operand_strides(make())
