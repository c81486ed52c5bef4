"""Port parity of the attention kernels' plain versions and the dispatch rule
(ops/flash_attention.py).  The JAX kernels run in the Pallas interpreter on
the CPU, as tests/test_flash.py runs them.  Every case has >= 128 tokens:
the dispatch sends shorter calls to sdpa.  Kernel-vs-plain checks on the
card are in chip_smoke.py and tests/test_torch_cuda_kernels.py.

Tolerance 2e-4 (f32): the TPU kernel's blocked online softmax and the plain
versions' single-pass softmax differ only in summation order."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu.ops import flash_attention as jfa
from tdc_video_tpu_torch.models.attention import attention
from tdc_video_tpu_torch.ops import flash_attention as tfa
from torch_parity import close, t

TOL = 2e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = False


def _qkv(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, T, Hq, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32))


def test_k1_causal_gqa_cache_longer_than_query():
    """K1: T=200 queries over an S=328 cache, top-left causal, GQA group 2,
    D=128; output and lse against the TPU kernel."""
    B, T, S, Hq, Hkv, D = 1, 200, 328, 4, 2, 128
    q, k, v = _qkv(0, B, T, S, Hq, Hkv, D)
    scale = 1 / math.sqrt(D)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out = tfa.flash_attention(t(q), t(k), t(v), causal=True)
    close(out, ref, TOL, TOL)
    # lse of the TPU kernel (_flash_gqa at the dispatch's block sizes)
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)
    _, lse_ref = jfa._flash_gqa(tr(q), tr(k), tr(v), causal=True, scale=scale,
                                block_q=256, block_k=384, groups=Hq // Hkv)
    o_p, lse = tfa.flash_attention_plain(t(q), t(k), t(v), scale, True)
    close(lse, np.asarray(lse_ref)[:, :, :T], TOL, TOL)
    close(o_p, ref, TOL, TOL)


def test_k1_right_padded_rows():
    """Valid rows of a right-padded prefill are unaffected by junk in the
    padding region, and agree with the TPU kernel."""
    B, T, H, D, valid = 1, 160, 2, 128, 97
    q, k, v = _qkv(1, B, T, T, H, H, D)
    q2, k2, v2 = q.copy(), k.copy(), v.copy()
    for a in (q2, k2, v2):
        a[:, valid:] = 1e3
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q2), jnp.asarray(k2), jnp.asarray(v2), causal=True))
    o1 = tfa.flash_attention(t(q), t(k), t(v), causal=True)
    o2 = tfa.flash_attention(t(q2), t(k2), t(v2), causal=True)
    close(o2[:, :valid], o1[:, :valid].numpy(), 1e-5, 1e-5)
    close(o2[:, :valid], ref[:, :valid], TOL, TOL)


@pytest.mark.parametrize(
    "name,H,D,N",
    [("full_attention_nhd", 4, 64, 130),  # K2: D=64 -> 128-lane blocks of 2 heads
     ("full_attention_nhd_seqq", 16, 72, 145)],  # K3: D=72 -> hb == Hq == 16
)
def test_k2_k3_nhd(name, H, D, N):
    q, k, v = _qkv(2, 2, N, N, H, H, D)
    assert tfa.select_kernel(N, N, H, H, D, False) == name
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    close(tfa.flash_attention(t(q), t(k), t(v), causal=False), ref, TOL, TOL)
    close(getattr(tfa, name + "_plain")(t(q), t(k), t(v), 1 / math.sqrt(D)), ref, TOL, TOL)


_JAX_BODY = {
    "_flash_kernel": "flash_kernel",
    "_full_attention_nhd_kernel": "full_attention_nhd",
    "_full_attention_nhd_seqq_kernel": "full_attention_nhd_seqq",
    "_full_attention_kernel": "full_attention",
}


@pytest.mark.parametrize(
    "T,S,Hq,Hkv,D,causal",
    [
        (128, 128, 4, 2, 64, True),  # causal GQA -> K1
        (128, 192, 2, 2, 64, True),  # cache longer than query -> K1
        (130, 130, 4, 4, 64, False),  # D=64 NHD -> K2
        (128, 128, 16, 16, 72, False),  # D=72, hb == Hq -> K3
        (128, 128, 8, 8, 72, False),  # D=72, hb=16 > Hq -> not NHD -> K4
        (128, 128, 4, 2, 64, False),  # non-causal GQA, T == S -> K4
        (128, 200, 2, 2, 64, False),  # non-causal, T != S -> K1 without the causal mask
    ],
)
def test_dispatch_picks_the_jax_kernel(monkeypatch, T, S, Hq, Hkv, D, causal):
    """The port's select_kernel names the Pallas body the JAX dispatch runs."""
    seen = []
    real = jfa.pl.pallas_call

    def spy(kernel, *a, **kw):
        seen.append(kernel.func.__name__)
        return real(kernel, *a, **kw)

    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    q, k, v = _qkv(3, 1, T, S, Hq, Hkv, D)
    jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    assert [_JAX_BODY[s] for s in seen] == [tfa.select_kernel(T, S, Hq, Hkv, D, causal)]


def test_k4_shapes_run_k4_and_agree_with_jax():
    """K4 is ported: maskless K4 shapes now run K4 (its plain version on the
    CPU) and agree with the JAX dispatch.  Only a non-causal call with a
    mask still raises NotImplementedError in the dispatch (before any
    kernel), and models/attention.py sends those to sdpa, as JAX does."""
    q, k, v = _qkv(4, 1, 128, 128, 4, 2, 64)
    assert tfa.select_kernel(128, 128, 4, 2, 64, False) == "full_attention"
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    close(tfa.flash_attention(t(q), t(k), t(v), causal=False), ref, TOL, TOL)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(t(q), t(k), t(v), mask=torch.ones(1, 1, 128, 128, dtype=torch.bool),
                            causal=False)


def test_cpu_wrappers_use_plain_versions_and_count_nothing():
    tfa.reset_launches()
    q, k, v = _qkv(5, 1, 130, 130, 4, 4, 64)
    tfa.full_attention_nhd(t(q), t(k), t(v), 0.125)
    o, lse = tfa.flash_kernel(t(q), t(k), t(v), 0.125, True)
    tfa.full_attention(t(q), t(k), t(v), 0.125)
    delta = torch.zeros_like(lse)
    tfa.flash_dq_kernel(t(q), t(k), t(v), o, lse, delta, 0.125, True)
    tfa.flash_dkv_kernel(t(q), t(k), t(v), o, lse, delta, 0.125, True)
    assert len(tfa.launches) == 6 and all(n == 0 for n in tfa.launches.values())
    # CPU attention(impl="flash") follows JAX on a non-TPU backend: sdpa
    out = attention(t(q), t(k), t(v), impl="flash")
    from tdc_video_tpu.models.layers import sdpa

    close(out, sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), TOL, TOL)

