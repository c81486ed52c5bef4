"""The LM steps of continuous batching against the JAX package, on the CPU
in f32 with shared tdc_tiny weights: decode_step's `active` mask and
extend_prefill (logits within 3e-4, the golden suite's bound; masks and
lengths exact), extend_prefill after a prefix against a one-shot prefill of
prefix + suffix (2e-5, summation order), and the engine's extends from one
stored prefix, which copy the donor so that it is never written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.serving.batching import DecodeEngine, Request
from torch_parity import close, t, to_torch


@pytest.fixture(scope="module")
def setup():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


def _prefilled(tp, jp, ids, mask, capacity, kv=None):
    """The same prefilled cache in both packages."""
    cfg, jcfg = tc.tdc_tiny(), jc.tdc_tiny()
    B = ids.shape[0]
    c = tlm.init_kv_cache(cfg.lm, B, capacity, dtype=cfg.dtype, device="cpu", quant=kv)
    emb = tlm.embed_tokens(cfg.lm, tp["lm"], t(ids), cfg.dtype)
    _, c = tlm.prefill(cfg.lm, tp["lm"], emb, t(mask), c, dtype=cfg.dtype)
    jcache = jlm.init_kv_cache(jcfg.lm, B, capacity, dtype=jcfg.dtype, quant=kv)
    jemb = jlm.embed_tokens(jcfg.lm, jp["lm"], jnp.asarray(ids), jcfg.dtype)
    _, jcache = jax.jit(lambda p, e, m, c: jlm.prefill(jcfg.lm, p, e, m, c, dtype=jcfg.dtype))(
        jp["lm"], jemb, jnp.asarray(mask), jcache)
    return c, jcache


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_decode_step_active_matches_jax(setup, kv):
    """Three decode steps with a changing active mask: the logits within
    3e-4 of JAX's; inactive rows keep their mask and lengths."""
    jp, tp = setup
    cfg, jcfg = tc.tdc_tiny(), jc.tdc_tiny()
    rng = np.random.default_rng(1)
    B, L = 3, 8
    ids = rng.integers(2, 100, (B, L)).astype(np.int32)
    mask = np.arange(L)[None] < np.array([[8], [5], [7]])
    c, jcache = _prefilled(tp, jp, ids, mask, L + 6, kv)
    jstep = jax.jit(lambda p, e, c_, a: jlm.decode_step(jcfg.lm, p, e, c_, dtype=jcfg.dtype,
                                                        active=a))
    for step, act in enumerate(([True, False, True], [False, True, True], [True, True, False])):
        act = np.array(act)
        tok = rng.integers(2, 100, (B, 1)).astype(np.int32)
        before = (c["mask"].clone(), c["lengths"].clone())
        lg, c = tlm.decode_step(cfg.lm, tp["lm"], tlm.embed_tokens(cfg.lm, tp["lm"], t(tok), cfg.dtype),
                                c, dtype=cfg.dtype, active=t(act))
        jlg, jcache = jstep(jp["lm"], jlm.embed_tokens(jcfg.lm, jp["lm"], jnp.asarray(tok),
                                                       jcfg.dtype), jcache, jnp.asarray(act))
        close(lg, jlg)
        np.testing.assert_array_equal(c["mask"].numpy(), np.asarray(jcache["mask"]))
        np.testing.assert_array_equal(c["lengths"].numpy(), np.asarray(jcache["lengths"]))
        np.testing.assert_array_equal(c["mask"][~t(act)].numpy(), before[0][~t(act)].numpy())
        np.testing.assert_array_equal(c["lengths"][~t(act)].numpy(), before[1][~t(act)].numpy())


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_extend_prefill_matches_jax(setup, kv):
    """A padded 5-token suffix with ragged valid lengths over a ragged
    prefix: logits within 3e-4, committed mask and lengths equal."""
    jp, tp = setup
    cfg, jcfg = tc.tdc_tiny(), jc.tdc_tiny()
    rng = np.random.default_rng(2)
    ids = rng.integers(2, 100, (2, 9)).astype(np.int32)
    mask = np.arange(9)[None] < np.array([[9], [6]])
    c, jcache = _prefilled(tp, jp, ids, mask, 20, kv)
    suffix = rng.integers(2, 100, (2, 5)).astype(np.int32)
    n_valid = np.array([5, 3], np.int32)
    lg, c = tlm.extend_prefill(cfg.lm, tp["lm"], tlm.embed_tokens(cfg.lm, tp["lm"], t(suffix),
                                                                   cfg.dtype),
                               t(n_valid), c, dtype=cfg.dtype)
    jlg, jcache = jax.jit(lambda p, e, n, c_: jlm.extend_prefill(jcfg.lm, p, e, n, c_,
                                                                 dtype=jcfg.dtype))(
        jp["lm"], jlm.embed_tokens(jcfg.lm, jp["lm"], jnp.asarray(suffix), jcfg.dtype),
        jnp.asarray(n_valid), jcache)
    close(lg, jlg)
    np.testing.assert_array_equal(c["mask"].numpy(), np.asarray(jcache["mask"]))
    np.testing.assert_array_equal(c["lengths"].numpy(), np.asarray(jcache["lengths"]))


def test_extend_after_prefix_equals_one_shot_prefill(setup):
    """Prefill 7 tokens, extend by 5: the next-token logits and the
    committed K/V of a one-shot prefill of all 12."""
    _, tp = setup
    cfg = tc.tdc_tiny()
    ids = np.random.default_rng(3).integers(2, 100, (1, 12)).astype(np.int32)
    emb = tlm.embed_tokens(cfg.lm, tp["lm"], t(ids), cfg.dtype)
    one = tlm.init_kv_cache(cfg.lm, 1, 16, dtype=cfg.dtype, device="cpu")
    ref, one = tlm.prefill(cfg.lm, tp["lm"], emb, torch.ones((1, 12), dtype=torch.bool), one,
                           dtype=cfg.dtype)
    two = tlm.init_kv_cache(cfg.lm, 1, 16, dtype=cfg.dtype, device="cpu")
    _, two = tlm.prefill(cfg.lm, tp["lm"], emb[:, :7], torch.ones((1, 7), dtype=torch.bool), two,
                         dtype=cfg.dtype)
    out, two = tlm.extend_prefill(cfg.lm, tp["lm"], emb[:, 7:], torch.tensor([5]), two,
                                  dtype=cfg.dtype)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(two["mask"].numpy(), one["mask"].numpy())
    np.testing.assert_array_equal(two["lengths"].numpy(), one["lengths"].numpy())
    for k in ("k", "v"):
        np.testing.assert_allclose(two[k][:, :, :12].numpy(), one[k][:, :, :12].numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_two_extends_from_one_donor(setup, kv):
    """The engine extends a stored prefix twice by the same suffix: equal
    logits and committed caches, and the donor bitwise as it was (extends
    write in place, so the engine extends a copy)."""
    _, tp = setup
    cfg = tc.tdc_tiny()
    eng = DecodeEngine(cfg, tp, num_slots=1, capacity=32, kv_quant=kv, device="cpu")
    ids = np.random.default_rng(4).integers(2, 100, (1, 14)).astype(np.int32)
    emb = tlm.embed_tokens(cfg.lm, tp["lm"], t(ids), cfg.dtype)
    donor = eng._prefill_prefix(emb[:, :9], torch.ones((1, 9), dtype=torch.bool))
    snapshot = {k: v.clone() for k, v in donor.items()}
    req = Request(embeds=emb, attn_mask=np.ones((1, 14), bool), prefix_key="p", prefix_len=9)
    eng.submit(req)
    first = eng._extend_suffix(req, donor)
    second = eng._extend_suffix(req, donor)
    assert torch.equal(first[1], second[1])
    for k in donor:
        assert torch.equal(first[2][k], second[2][k]), k
        assert torch.equal(donor[k], snapshot[k]), k
    assert int(first[2]["lengths"][0]) == 14 and int(donor["lengths"][0]) == 9
