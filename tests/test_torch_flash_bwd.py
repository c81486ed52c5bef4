"""Port parity of the training kernels' plain versions (K4 full attention
with lse, K5 dQ, K6 dK/dV) and of the two autograd Functions that wrap the
kernels (ops/flash_attention.py), against the JAX package with its Pallas
kernels in the interpreter on the CPU, as tests/test_flash.py runs them.
Kernel-vs-plain checks on the card are in tests/test_torch_cuda_kernels.py
and chip_smoke.py.

Tolerance 1e-4 (f32): the TPU kernels' blocked sums and the plain
versions' single-pass sums differ only in order."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu.ops import flash_attention as jfa
from tdc_video_tpu_torch.ops import flash_attention as tfa
from torch_parity import close, t

TOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


def _bhtd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _btHd(x):
    return np.asarray(x).transpose(0, 2, 1, 3)


def _block(n):
    """The JAX dispatch's block for a short sequence (pick_block)."""
    return max(128, -(-n // 128) * 128)


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_k4_plain_matches_flash_full(Hq, Hkv):
    """K4: o and the f32 lse of the plain version against _flash_full at
    S=160 (padded to 256 on the TPU path), MHA and GQA 2."""
    B, S, D = 2, 160, 64
    q, k, v = _rand(0, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    scale = 1 / math.sqrt(D)
    o_ref, lse_ref = jfa._flash_full(_bhtd(q), _bhtd(k), _bhtd(v), scale, Hq // Hkv)
    o, lse = tfa.full_attention_plain(t(q), t(k), t(v), scale)
    assert tfa.select_kernel(S, S, Hq, Hkv, D, False) == ("full_attention" if Hq != Hkv
                                                          else "full_attention_nhd")
    close(o, _btHd(o_ref), TOL, TOL)
    close(lse, np.asarray(lse_ref)[:, :, :S], TOL, TOL)
    o_w, lse_w = tfa.full_attention(t(q), t(k), t(v), scale)  # the CPU wrapper
    close(o_w, _btHd(o_ref), TOL, TOL)
    close(lse_w, np.asarray(lse_ref)[:, :, :S], TOL, TOL)


@pytest.mark.parametrize(
    "B,T,Hq,Hkv,D,causal",
    [
        (1, 128, 4, 2, 64, True),
        (2, 200, 4, 4, 64, True),  # padded to the block on the TPU path
        (1, 256, 8, 2, 128, True),  # GQA group 4
        (1, 160, 4, 4, 64, False),  # non-causal full (ViT towers)
    ],
)
def test_k5_k6_plain_match_flash_gqa_bwd(B, T, Hq, Hkv, D, causal):
    """K5 and K6 plain versions against _flash_gqa_bwd, given the same o,
    lse and dO (the cases of tests/test_flash.py::TestBackward)."""
    q, k, v, do = _rand(1, (B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D))
    scale = 1 / math.sqrt(D)
    blk = _block(T)
    o, lse = jfa._flash_gqa(_bhtd(q), _bhtd(k), _bhtd(v), causal=causal, scale=scale,
                            block_q=blk, block_k=blk, groups=Hq // Hkv)
    dq_r, dk_r, dv_r = jfa._flash_gqa_bwd(_bhtd(q), _bhtd(k), _bhtd(v), o, lse, _bhtd(do),
                                          causal=causal, scale=scale, block_q=blk, block_k=blk,
                                          groups=Hq // Hkv)
    o_t = t(_btHd(o))
    lse_t = t(np.asarray(lse)[:, :, :T])
    delta = (t(do) * o_t).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    dq = tfa.flash_dq_plain(t(q), t(k), t(v), t(do), lse_t, delta, scale, causal)
    dk, dv = tfa.flash_dkv_plain(t(q), t(k), t(v), t(do), lse_t, delta, scale, causal)
    close(dq, _btHd(dq_r), TOL, TOL)
    close(dk, _btHd(dk_r), TOL, TOL)
    close(dv, _btHd(dv_r), TOL, TOL)


def _weighted_grads_jax(fn, q, k, v, w):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _weighted_grads_port(fn, q, k, v, w):
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    (fn(*leaves) * t(w)).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize(
    "B,T,Hq,Hkv,D,causal",
    [(1, 128, 4, 2, 64, True), (1, 256, 8, 2, 128, True), (2, 133, 4, 2, 72, False)],
)
def test_flash_core_autograd_matches_jax(B, T, Hq, Hkv, D, causal):
    """_FlashCore (K1 causal, K4 for non-causal GQA) through
    flash_attention against jax.grad of the JAX flash_attention."""
    q, k, v, w = _rand(2, (B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D), (B, T, Hq, D))
    ref = _weighted_grads_jax(lambda a, b, c: jfa.flash_attention(a, b, c, causal=causal),
                              q, k, v, w)
    out = _weighted_grads_port(lambda a, b, c: tfa.flash_attention(a, b, c, causal=causal),
                               q, k, v, w)
    for a, b in zip(out, ref):
        close(a, b, TOL, TOL)


@pytest.mark.parametrize("H,D", [(8, 64), (16, 72)])
def test_flash_full_nhd_autograd_matches_jax(H, D):
    """_FlashFullNHD (K2 at D=64, K3 at D=72; backward K4 + K5 + K6) against
    jax.grad of _flash_full_nhd at N=133."""
    B, N = 2, 133
    q, k, v = _rand(3, (B, N, H, D), (B, N, H, D), (B, N, H, D))
    scale = 1 / math.sqrt(D)
    name = tfa.select_kernel(N, N, H, H, D, False)
    assert name == ("full_attention_nhd" if D == 64 else "full_attention_nhd_seqq")
    ref = jax.grad(lambda a, b, c: (jfa._flash_full_nhd(a, b, c, scale, 1) ** 2).sum(),
                   argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    (tfa._FlashFullNHD.apply(*leaves, scale, name) ** 2).sum().backward()
    for a, b in zip(leaves, ref):
        close(a.grad, b, TOL, TOL)
    # the dispatch reaches the same Function
    out = _weighted_grads_port(lambda a, b, c: tfa.flash_attention(a, b, c, causal=False) ** 2,
                               q, k, v, np.ones((B, N, H, D), np.float32))
    for a, b in zip(out, ref):
        close(a, b, TOL, TOL)


def test_padded_rows_zero_dq():
    """Right-padded rows (dO = 0 there) get exactly zero dQ, and the
    gradients match JAX's (tests/test_flash.py::test_padded_rows_zero_grad)."""
    B, T, H, D, valid = 1, 128, 2, 64, 100
    q, k, v = _rand(4, (B, T, H, D), (B, T, H, D), (B, T, H, D))
    keep = (np.arange(T) < valid)[None, :, None, None]

    def jloss(a, b, c):
        return jnp.sum(jnp.where(keep, jfa.flash_attention(a, b, c, causal=True), 0.0) ** 2)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=True)
    (torch.where(t(keep), o, 0.0) ** 2).sum().backward()
    assert float(leaves[0].grad[:, valid:].abs().max()) == 0.0
    for a, b in zip(leaves, ref):
        close(a.grad, b, TOL, TOL)
