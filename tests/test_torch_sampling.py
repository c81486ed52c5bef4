"""The port's sampling against the JAX package on the CPU: JAX's threefry
keys (serving/prng.py) bit for bit, the HF-order warpers exactly, and the
sampled tokens of sample_logits, sample_rows, accept_and_emit_sampled and
the decode loop identical.  The cases of tests/test_sampling.py are
mirrored on the port.

gumbel goes through two f32 logs, whose last bit can differ between XLA's
and PyTorch's CPU kernels: it is held within 1e-6 (relative, 1e-6 absolute
near 0), and the sampled tokens can part only where two perturbed logits lie
within ~1e-6 of each other.  The seeds and the random-normal logits here
have no such near tie, so every token comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.serving import generate as jgen
from tdc_video_tpu.serving import speculative as jspec
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.serving import generate as tgen
from tdc_video_tpu_torch.serving import prng
from tdc_video_tpu_torch.serving import speculative as tspec
from torch_parity import t, to_torch


def _jkey_data(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 - 1])
def test_keys_and_bits_bitwise(seed):
    """PRNGKey, fold_in, split, the raw 32-bit bits (odd and even sizes,
    several shapes) and uniform, each bitwise equal to jax.random's."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _jkey_data(jk))
    for data in (0, 1, 12345, 2**31 - 1, -1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      _jkey_data(jax.random.fold_in(jk, np.int32(data))))
    for num in (2, 3):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      _jkey_data(jax.random.split(jk, num)))
    for shape in ((1,), (7,), (4, 5), (3, 1, 9)):
        ref = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(), ref)
    np.testing.assert_array_equal(prng.uniform(tk, (1001,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (1001,))))
    np.testing.assert_array_equal(prng.uniform(tk).numpy(), np.asarray(jax.random.uniform(jk)))


def test_batched_keys_are_vmapped_keys():
    """Keys with batch dimensions draw as jax.vmap over keys: fold_in of a
    vector of data, and the bits of each key."""
    data = np.array([3, 0, 2**31 - 1, 99], np.int32)
    jkeys = jax.vmap(lambda d: jax.random.fold_in(jax.random.PRNGKey(5), d))(jnp.asarray(data))
    tkeys = prng.fold_in(prng.PRNGKey(5), torch.from_numpy(data))
    np.testing.assert_array_equal(tkeys.numpy(), _jkey_data(jkeys))
    ref = jax.vmap(lambda k: jax.random.bits(k, (6,), jnp.uint32))(jkeys)
    np.testing.assert_array_equal(prng.random_bits(tkeys, (6,)).numpy(),
                                  np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("seed", [1, 2])
def test_gumbel_close(seed):
    ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (4096,)))
    out = prng.gumbel(prng.PRNGKey(seed), (4096,)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _logits(seed, shape, scale=2.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_token_identical(seed):
    """One key over [B, V] (JAX's one-key call) and one key a row (vmapped)."""
    x = _logits(seed, (4, 300))
    ref = jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(x))
    np.testing.assert_array_equal(prng.categorical(prng.PRNGKey(seed), t(x)).numpy(),
                                  np.asarray(ref))
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 4)
    ref = jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(x))
    out = prng.categorical(prng.split(prng.PRNGKey(seed), 4), t(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


WARPS = [(0.2, 50, 1.0), (1.0, 0, 0.9), (0.7, 20, 0.8), (1.3, 5, 1.0), (0.9, 0, 1.0)]


@pytest.mark.parametrize("temperature,top_k,top_p", WARPS)
def test_sample_logits_token_identical(temperature, top_k, top_p):
    x = _logits(3, (3, 500))
    for seed in range(4):
        ref = jgen.sample_logits(jnp.asarray(x), jax.random.PRNGKey(seed), temperature, top_k,
                                 top_p)
        out = tgen.sample_logits(t(x), prng.PRNGKey(seed), temperature, top_k, top_p)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = jgen.temperature_sample(jnp.asarray(x), jax.random.PRNGKey(9), temperature)
    out = tgen.temperature_sample(t(x), prng.PRNGKey(9), temperature)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", [1, 7, 64])
def test_top_k_filter_exact(k):
    x = _logits(4, (4, 200))
    np.testing.assert_array_equal(tgen.top_k_filter(t(x), k).numpy(),
                                  np.asarray(jgen.top_k_filter(jnp.asarray(x), k)))


@pytest.mark.parametrize("p", [0.3, 0.8, 0.95])
def test_top_p_filter_exact(p):
    x = _logits(5, (4, 200))
    np.testing.assert_array_equal(tgen.top_p_filter(t(x), p).numpy(),
                                  np.asarray(jgen.top_p_filter(jnp.asarray(x), p)))


def _row_params():
    """Six rows: greedy, sampled with each filter alone and together, and
    the disabled values (top_k <= 0, top_p >= 1)."""
    temp = np.array([0.0, 0.7, 1.0, 1.5, 0.2, 0.0], np.float32)
    topk = np.array([50, 0, 10, 3, 50, 0], np.int32)
    topp = np.array([1.0, 0.9, 1.0, 0.6, 0.95, 0.5], np.float32)
    seed = np.array([0, 1, 2, 3, 4, 5], np.int32)
    idx = np.array([0, 3, 1, 7, 12, 2], np.int32)
    return temp, topk, topp, seed, idx


def test_filter_rows_exact():
    x = _logits(6, (6, 400))
    temp, topk, topp, _, _ = _row_params()
    ref = jgen.filter_rows(jnp.asarray(x), *map(jnp.asarray, (temp, topk, topp)))
    out = tgen.filter_rows(t(x), t(temp), t(topk), t(topp))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_rows_mixed_greedy_and_sampled(seed):
    """Mixed rows: the greedy rows give the argmax, the sampled rows JAX's
    counter-mode tokens."""
    x = _logits(10 + seed, (6, 400))
    args = _row_params()
    ref = jgen.sample_rows(jnp.asarray(x), *map(jnp.asarray, args))
    out = tgen.sample_rows(t(x), *map(t, args))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    greedy = args[0] <= 0
    np.testing.assert_array_equal(out.numpy()[greedy], x.argmax(-1)[greedy])


@pytest.mark.parametrize("case", range(4))
def test_accept_and_emit_sampled_matches_jax(case):
    """Rejection sampling with deterministic drafts: the same emitted
    tokens, counts and EOS flags as JAX's over rows that are greedy,
    sampled, done or budget-cut, with drafts that the warped distribution
    accepts and rejects."""
    rng = np.random.default_rng(20 + case)
    B, K, V = 4, 4, 64
    logits = rng.normal(0, 3, (B, K, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = rng.integers(0, V, (B, K - 1)).astype(np.int32)
    draft[0] = greedy[0, :-1]  # a greedy row whose drafts agree
    draft[1, :2] = greedy[1, :2]  # likely drafts on a sampled row
    eos = np.array([int(greedy[2, 1]), 1], np.int32)
    remaining = np.array([9, 9, 9, 2], np.int32)
    done = np.array([False, False, False, case == 3])
    temp = np.array([0.0, 0.8, 1.0, 1.2], np.float32)
    topk = np.array([0, 20, 0, 5], np.int32)
    topp = np.array([1.0, 0.9, 1.0, 1.0], np.float32)
    seed = np.array([case, 1, 2, 3], np.int32)
    gidx = np.array([1, 5, 0, 9], np.int32)
    args = (logits, draft, eos, remaining, done, temp, topk, topp, seed, gidx)
    ref = jspec.accept_and_emit_sampled(*map(jnp.asarray, args))
    out = tspec.accept_and_emit_sampled(*map(t, args))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


# -- the cases of tests/test_sampling.py, on the port --------------------------


def test_top_k_keeps_exactly_k():
    logits = t(_logits(0, (4, 100), 3.0))
    out = tgen.top_k_filter(logits, 10).numpy()
    finite = np.isfinite(out)
    assert (finite.sum(-1) == 10).all()
    for r in range(4):
        assert set(np.where(finite[r])[0]) == set(np.argsort(logits[r].numpy())[-10:])


def test_top_p_nucleus_rule():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))
    out = tgen.top_p_filter(logits, 0.7).numpy()
    assert np.isfinite(out[0, :2]).all() and np.isinf(out[0, 2:]).all()
    out = tgen.top_p_filter(logits, 0.95).numpy()
    assert np.isfinite(out[0, :3]).all() and np.isinf(out[0, 3]).all()


def test_temperature_zero_is_greedy():
    x = _logits(1, (3, 50), 1.0)
    out = tgen.sample_logits(t(x), prng.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), x.argmax(-1))


def test_top_k_one_is_greedy_at_any_temperature():
    x = _logits(2, (3, 50), 1.0)
    out = tgen.sample_logits(t(x), prng.PRNGKey(3), temperature=1.7, top_k=1)
    np.testing.assert_array_equal(out.numpy(), x.argmax(-1))


def test_samples_stay_inside_nucleus():
    x = t(_logits(3, (1, 200), 4.0))
    kept = np.where(np.isfinite(tgen.top_k_filter(x, 5).numpy()[0]))[0]
    for i in range(20):
        assert int(tgen.sample_logits(x, prng.PRNGKey(i), temperature=1.0, top_k=5)[0]) in kept


def test_filter_rows_top_p_one_is_no_op():
    """top_p >= 1 disables nucleus filtering exactly, even where the f32
    cumsum reaches 1.0 before the tail."""
    logits = torch.tensor([[20.0] + [0.0] * 7])
    one, zero = torch.tensor([1.0]), torch.tensor([0], dtype=torch.int32)
    assert np.isfinite(tgen.filter_rows(logits, one, zero, torch.tensor([1.0])).numpy()).all()
    out = tgen.filter_rows(logits, one, zero, torch.tensor([0.9])).numpy()
    assert np.isfinite(out[0, 0]) and not np.isfinite(out[0, 1:]).any()


@pytest.fixture(scope="module")
def params():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


@pytest.mark.parametrize("key_seed", [7, 8])
def test_sampled_text_decode_token_identical(params, key_seed):
    """generate_text_only with do_sample settings: reproducible for a fixed
    key, valid ids, and JAX's tokens (the first token from one split of the
    key, then one split a step)."""
    jp, tp = params
    ids = np.random.default_rng(4).integers(2, 50, (2, 8)).astype(np.int32)
    mask = np.ones(ids.shape, bool)
    kw = dict(max_new_tokens=6, temperature=0.2, top_k=50, top_p=0.9)
    a = tgen.generate_text_only(tc.tdc_tiny(), tp, t(ids), t(mask), key=prng.PRNGKey(key_seed),
                                **kw)
    b = tgen.generate_text_only(tc.tdc_tiny(), tp, t(ids), t(mask), key=prng.PRNGKey(key_seed),
                                **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert ((a.numpy() >= 0) & (a.numpy() < tc.tdc_tiny().lm.vocab_size)).all()
    ref = jax.jit(lambda p, i, m, key: jgen.generate_text_only(jc.tdc_tiny(), p, i, m, key=key,
                                                               **kw))(
        jp, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(key_seed))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
