"""Prompt-lookup speculative decoding of the port (serving/speculative.py,
lm.verify_step / commit_verified) against the JAX package and the port's
own plain loop, on the CPU in f32 with shared tdc_tiny weights (greedy
cases of tests/test_speculative.py).

Greedy speculation is exact, so every decode comparison is token-identical
(tolerance 0); verify logits against sequential decode steps and against
JAX within 2e-5 (JAX's own bound) and 3e-4 (golden suite).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.serving import speculative as jspec
from tdc_video_tpu.serving.generate import generate_text_only
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.serving import speculative as tspec
from tdc_video_tpu_torch.serving.generate import decode_loop
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer, close, t, to_torch


@pytest.fixture(scope="module")
def setup():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


def _propose_oracle(hist, hist_len, n, k):
    """Python reference: the most recent earlier occurrence of the trailing
    n-gram."""
    drafts, founds = [], []
    for b in range(hist.shape[0]):
        h = list(hist[b, : hist_len[b]])
        gram = h[-n:]
        best = -1
        for i in range(len(h) - n):
            if h[i: i + n] == gram:
                best = i
        founds.append(best >= 0)
        start = best + n if best >= 0 else 0
        row = list(hist[b])
        drafts.append([row[min(start + j, hist.shape[1] - 1)] for j in range(k)])
    return np.asarray(drafts), np.asarray(founds)


def test_propose_ngram_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 4, (8, 48)).astype(np.int32)  # vocab 4: many 2-gram repeats
    hist_len = rng.integers(10, 41, (8,)).astype(np.int32)
    d, f = tspec.propose_ngram(t(hist), t(hist_len), n=2, k=5)
    jd, jf = jspec.propose_ngram(jnp.asarray(hist), jnp.asarray(hist_len), n=2, k=5)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    want_d, want_f = _propose_oracle(hist, hist_len, 2, 5)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_array_equal(d.numpy()[want_f], want_d[want_f])


@pytest.mark.parametrize("hist,hist_len,n,k,found,draft", [
    ([7, 8, 1, 2, 7, 8, 3, 4, 7, 8], 10, 2, 2, True, [3, 4]),  # the later occurrence wins
    ([1, 2, 3, 4, 5, 6, 0, 0, 0, 0], 6, 2, 2, False, None),  # no earlier occurrence
    ([5, 6, 1, 2, 9, 9, 1, 2, 1, 2], 4, 2, 1, False, None),  # the pad past hist_len never matches
], ids=["recency", "no_match", "ignores_padding"])
def test_propose_ngram_cases(hist, hist_len, n, k, found, draft):
    d, f = tspec.propose_ngram(torch.tensor([hist], dtype=torch.int32),
                               torch.tensor([hist_len], dtype=torch.int32), n=n, k=k)
    assert bool(f[0]) == found
    if draft is not None:
        assert d[0].tolist() == draft


@pytest.mark.parametrize("greedy,draft,remaining,done,m,eos", [
    ([10, 20, 30, 40], [10, 20, 99], 64, False, 3, False),  # 2 drafts agree + bonus
    ([10, 20, 30, 40], [99, 20, 30], 64, False, 1, False),  # first draft wrong: bonus only
    ([10, 20, 30, 40], [10, 20, 30], 64, False, 4, False),  # the whole window
    ([10, 1, 30, 40], [10, 1, 30], 64, False, 2, True),  # up to and including the EOS
    ([10, 1, 30, 40], [10, 1, 30], 1, False, 1, False),  # the budget cuts before the EOS
    ([10, 1, 30, 40], [10, 1, 30], 64, True, 0, False),  # done rows emit nothing
])
def test_accept_and_emit_matches_jax(greedy, draft, remaining, done, m, eos):
    args = ([greedy], [draft], [1], [remaining], [done])
    tm, te = tspec.accept_and_emit(*(torch.tensor(a, dtype=torch.bool if i == 4 else torch.int32)
                                     for i, a in enumerate(args)))
    jm, je = jspec.accept_and_emit(*(jnp.asarray(a, bool if i == 4 else jnp.int32)
                                     for i, a in enumerate(args)))
    assert (int(tm[0]), bool(te[0])) == (m, eos) == (int(jm[0]), bool(je[0]))


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_verify_step_matches_decode_steps_and_jax(setup, kv):
    """K tokens through K decode_steps and through one verify_step +
    commit_verified: per-position logits within 2e-5, the same committed
    mask, lengths and valid K/V; and the verify logits within 3e-4 of
    JAX's."""
    jp, tp = setup
    cfg, jcfg = tc.tdc_tiny(), jc.tdc_tiny()
    rng = np.random.default_rng(3)
    B, L, K = 2, 9, 4
    ids = rng.integers(2, 100, (B, L)).astype(np.int32)
    mask = np.arange(L)[None] < np.array([[L], [L - 3]])
    toks = rng.integers(2, 100, (B, K)).astype(np.int32)

    def fresh():
        c = tlm.init_kv_cache(cfg.lm, B, L + K + 2, dtype=cfg.dtype, device="cpu", quant=kv)
        emb = tlm.embed_tokens(cfg.lm, tp["lm"], t(ids), cfg.dtype)
        return tlm.prefill(cfg.lm, tp["lm"], emb, t(mask), c, dtype=cfg.dtype)[1]

    c_seq, seq = fresh(), []
    for j in range(K):
        e = tlm.embed_tokens(cfg.lm, tp["lm"], t(toks[:, j:j + 1]), cfg.dtype)
        lg, c_seq = tlm.decode_step(cfg.lm, tp["lm"], e, c_seq, dtype=cfg.dtype)
        seq.append(lg)
    e = tlm.embed_tokens(cfg.lm, tp["lm"], t(toks), cfg.dtype)
    ver, c_ver = tlm.verify_step(cfg.lm, tp["lm"], e, fresh(), dtype=cfg.dtype)
    c_ver = tlm.commit_verified(c_ver, torch.full((B,), K, dtype=torch.int32))
    np.testing.assert_allclose(ver.numpy(), torch.stack(seq, 1).numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(c_ver["lengths"].numpy(), c_seq["lengths"].numpy())
    np.testing.assert_array_equal(c_ver["mask"].numpy(), c_seq["mask"].numpy())
    valid = c_seq["mask"].numpy()
    for name in ("k", "v") + (("k_scale", "v_scale") if kv else ()):
        np.testing.assert_allclose(c_ver[name].numpy()[:, valid], c_seq[name].numpy()[:, valid],
                                   rtol=1e-6, atol=1e-6 if not kv else 1)

    jc_ = jlm.init_kv_cache(jcfg.lm, B, L + K + 2, dtype=jcfg.dtype, quant=kv)
    jemb = jlm.embed_tokens(jcfg.lm, jp["lm"], jnp.asarray(ids), jcfg.dtype)
    _, jc_ = jlm.prefill(jcfg.lm, jp["lm"], jemb, jnp.asarray(mask), jc_, dtype=jcfg.dtype)
    jver, _ = jlm.verify_step(jcfg.lm, jp["lm"],
                              jlm.embed_tokens(jcfg.lm, jp["lm"], jnp.asarray(toks), jcfg.dtype),
                              jc_, dtype=jcfg.dtype)
    close(ver, jver)


def _port_generate(cfg, tp, ids, mask, new, kv_quant=None, spec_window=0, spec_ngram=3):
    """The port's text-only greedy generation: prefill, then the plain or
    the speculative loop (generate_text_only's chain in JAX)."""
    B, L = ids.shape
    emb = tlm.embed_tokens(cfg.lm, tp["lm"], t(ids), cfg.dtype)
    cache = tlm.init_kv_cache(cfg.lm, B, L + new + max(spec_window - 1, 0), dtype=cfg.dtype,
                              device="cpu", quant=kv_quant)
    logits, cache = tlm.prefill(cfg.lm, tp["lm"], emb, t(mask), cache, dtype=cfg.dtype)
    first = logits.argmax(-1).to(torch.int32)
    if spec_window:
        out, _ = tspec.pld_decode_loop(cfg, tp, cache, first, t(ids), t(mask).sum(-1), new,
                                       window=spec_window, ngram=spec_ngram)
    else:
        out, _ = decode_loop(cfg, tp, cache, first, new)
    return out.numpy()


def _ragged():
    rng = np.random.default_rng(7)
    ids = rng.integers(2, 100, (3, 14)).astype(np.int32)
    lens = np.array([14, 9, 5])
    ids[np.arange(14)[None] >= lens[:, None]] = 0
    return ids, np.arange(14)[None] < lens[:, None]


def _repetitive():
    base = np.array([4, 9, 17] * 4, np.int32)
    return np.stack([base, base[::-1].copy()]), np.ones((2, 12), bool)


CASES = {
    # name: (prompt ids, mask, new tokens, window, ngram, kv_quant)
    "random_prompt": (np.random.default_rng(5).integers(2, 100, (2, 12)).astype(np.int32),
                      np.ones((2, 12), bool), 12, 4, 2, None),
    "repetitive_prompt": _repetitive() + (16, 6, 2, None),
    "ragged_batch": _ragged() + (10, 4, 3, None),
    "int8_kv": (np.random.default_rng(11).integers(2, 100, (2, 12)).astype(np.int32),
                np.ones((2, 12), bool), 10, 4, 2, "int8"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pld_decode_token_identical(setup, case):
    """pld_decode_loop gives the port's plain greedy tokens and JAX's
    speculative ones."""
    jp, tp = setup
    ids, mask, new, window, ngram, kv = CASES[case]
    plain = _port_generate(tc.tdc_tiny(), tp, ids, mask, new, kv_quant=kv)
    spec = _port_generate(tc.tdc_tiny(), tp, ids, mask, new, kv_quant=kv, spec_window=window,
                          spec_ngram=ngram)
    ref = generate_text_only(jc.tdc_tiny(), jp, jnp.asarray(ids), jnp.asarray(mask),
                             max_new_tokens=new, kv_quant=kv, spec_window=window,
                             spec_ngram=ngram)
    np.testing.assert_array_equal(spec, plain)
    np.testing.assert_array_equal(spec, np.asarray(ref))


def test_pld_eos_truncation_matches(setup):
    """An EOS the greedy stream produces: both loops stop there and pad the
    rest, as JAX's."""
    jp, tp = setup
    ids = np.random.default_rng(9).integers(2, 100, (1, 10)).astype(np.int32)
    mask = np.ones(ids.shape, bool)
    probe = _port_generate(tc.tdc_tiny(), tp, ids, mask, 8)
    eos = int(probe[0, 4])  # the 5th generated token becomes "eos"
    tcfg = dataclasses.replace(tc.tdc_tiny(),
                               lm=dataclasses.replace(tc.LM_TINY, eos_token_ids=(eos,)))
    jcfg = dataclasses.replace(jc.tdc_tiny(),
                               lm=dataclasses.replace(jc.LM_TINY, eos_token_ids=(eos,)))
    plain = _port_generate(tcfg, tp, ids, mask, 8)
    spec = _port_generate(tcfg, tp, ids, mask, 8, spec_window=4, spec_ngram=2)
    ref = generate_text_only(jcfg, jp, jnp.asarray(ids), jnp.asarray(mask), max_new_tokens=8,
                             spec_window=4, spec_ngram=2)
    np.testing.assert_array_equal(spec, plain)
    np.testing.assert_array_equal(spec, np.asarray(ref))
    cut = int(np.where(plain[0] == eos)[0][0])
    assert (plain[0, cut + 1:] == tcfg.lm.pad_token_id).all()


def test_answer_spec_window_token_identical(setup):
    """TDCPredictor.answer(spec_window=4) against JAX's and against the
    port's plain answer; f32 compressor as the other answer tests."""
    jp, tp = setup
    jcfg = dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    frames = np.random.default_rng(3).integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    frames[3:, :, :32] = 255 - frames[3:, :, :32]
    jpred = JaxPredictor(jcfg, jp, JaxStubTokenizer(), max_new_tokens=8, text_bucket=128,
                         spec_window=4)
    tpred = TorchPredictor(tcfg, tp, StubTokenizer(), max_new_tokens=8, text_bucket=128,
                           device="cpu", spec_window=4)
    plain = TorchPredictor(tcfg, tp, StubTokenizer(), max_new_tokens=8, text_bucket=128,
                           device="cpu")
    for question in ("What happens?", "Which color is on the left?"):
        out = tpred.answer(frames, question, video_uid="clip")
        assert out == jpred.answer(frames, question, video_uid="clip")
        assert out == plain.answer(frames, question, video_uid="clip")
        assert tpred.stats.decode_steps <= plain.stats.decode_steps
