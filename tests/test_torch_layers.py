"""Port parity: tdc_video_tpu_torch.models.layers vs tdc_video_tpu.models.layers
(f32 on the CPU, tolerance 3e-4 as the golden suite)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu.models import layers as jl
from tdc_video_tpu_torch.models import layers as tl
from torch_parity import close, t, to_torch


@pytest.fixture
def x():
    return np.random.default_rng(0).normal(0, 1, (2, 5, 16)).astype(np.float32)


@pytest.mark.parametrize("bias", [True, False])
def test_linear(x, bias):
    p = jl.init_linear(jax.random.PRNGKey(0), 16, 24, jnp.float32, bias=bias)
    if bias:
        p = dict(p, b=jnp.linspace(-1, 1, 24))
    close(tl.linear(to_torch(p), t(x)), jl.linear(p, jnp.asarray(x)))


def test_layer_norm_and_rms_norm(x):
    rng = np.random.default_rng(1)
    ln = {"scale": rng.normal(1, 0.1, 16).astype(np.float32), "bias": rng.normal(0, 0.1, 16).astype(np.float32)}
    close(tl.layer_norm(to_torch(ln), t(x), 1e-5), jl.layer_norm(ln, jnp.asarray(x), 1e-5))
    rms = {"scale": ln["scale"]}
    close(tl.rms_norm(to_torch(rms), t(x), 1e-6), jl.rms_norm(rms, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_mlp(x, approximate):
    p = jl.init_gelu_mlp(jax.random.PRNGKey(1), 16, 32, jnp.float32)
    close(tl.gelu_mlp(to_torch(p), t(x), approximate), jl.gelu_mlp(p, jnp.asarray(x), approximate))


def test_swiglu_mlp(x):
    p = jl.init_swiglu_mlp(jax.random.PRNGKey(2), 16, 32, jnp.float32)
    close(tl.swiglu_mlp(to_torch(p), t(x)), jl.swiglu_mlp(p, jnp.asarray(x)))


@pytest.mark.parametrize("scaling", [None, (32.0, 1.0, 4.0, 8192)])
def test_rope(scaling):
    """inv_freq with and without Llama-3 scaling, cos/sin and the rotation."""
    D = 128
    inv_j = jl.rope_inv_freq(D, 500000.0, scaling)
    inv_t = tl.rope_inv_freq(D, 500000.0, scaling)
    close(inv_t, inv_j, atol=0, rtol=1e-6)
    pos = np.array([[0, 1, 5, 1000, 70000]], np.int32)
    cj, sj = jl.rope_cos_sin(jnp.asarray(pos), inv_j)
    ct, st = tl.rope_cos_sin(t(pos), inv_t)
    close(ct, cj, atol=1e-4)
    close(st, sj, atol=1e-4)
    xq = np.random.default_rng(3).normal(0, 1, (1, 5, 3, D)).astype(np.float32)
    close(tl.apply_rope(t(xq), ct, st), jl.apply_rope(jnp.asarray(xq), cj, sj))


def test_make_causal_mask():
    for T, S, off in [(4, 4, 0), (3, 7, 2)]:
        np.testing.assert_array_equal(tl.make_causal_mask(T, S, off).numpy(),
                                      np.asarray(jl.make_causal_mask(T, S, off)))


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_gqa(masked):
    rng = np.random.default_rng(4)
    B, T, S, Hq, Hkv, D = 2, 6, 9, 4, 2, 8
    q = rng.normal(0, 1, (B, T, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, Hkv, D)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(S)[None, None, None] < np.array([5, 9])[:, None, None, None]) & \
               np.tril(np.ones((T, S), bool), 3)[None, None]
    ref = jl.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  None if mask is None else jnp.asarray(mask))
    out = tl.sdpa(t(q), t(k), t(v), None if mask is None else t(mask))
    close(out, ref)
