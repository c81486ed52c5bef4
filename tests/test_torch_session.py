"""Multi-turn ChatSession of the port (serving/session.py) against the JAX
package's, on the CPU with shared tdc_tiny weights (f32 compressor, as the
other token-identity tests): the template glue and the plain encoding equal
for the ChatML, Llama-3 and plain templates, three turns token-identical
(tolerance 0) with a growing resident cache and no re-prefill, and the
donor released on close.
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
from tdc_video_tpu.serving import session as jsess
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.eval.runner import TDCPredictor as TorchPredictor
from tdc_video_tpu_torch.serving import session as tsess
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer, to_torch


class _Cfg:
    def __init__(self, version):
        self.conv_version = version


@pytest.mark.parametrize("closed", [True, False], ids=["closed", "cut"])
@pytest.mark.parametrize("version", ["qwen", "llama3_2", "plain"])
def test_follow_up_text_equals_jax(version, closed):
    out = tsess.follow_up_text(_Cfg(version), "Why red?", closed)
    assert out == jsess.follow_up_text(_Cfg(version), "Why red?", closed)
    if version == "qwen" and closed:
        assert out == "\n<|im_start|>user\nWhy red?<|im_end|>\n<|im_start|>assistant\n"


def test_encode_plain_equals_jax():
    """With an HF tokenizer behind the adapter: no special tokens; without
    one (or without the keyword): the adapter's encode."""

    class Tok:
        def __call__(self, text, add_special_tokens=True):
            class Out:
                input_ids = [5, 6] if not add_special_tokens else [0, 5, 6]

            return Out()

    class Adapter:
        tok = Tok()

    assert tsess.encode_plain(Adapter(), "hi") == jsess.encode_plain(Adapter(), "hi") == [5, 6]
    glue = tsess.follow_up_text(_Cfg("qwen"), "Why?", True)
    assert tsess.encode_plain(StubTokenizer(), glue) == jsess.encode_plain(JaxStubTokenizer(),
                                                                           glue)


@pytest.fixture(scope="module")
def predictors():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    jcfg = dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    jpred = JaxPredictor(jcfg, jp, JaxStubTokenizer(), max_new_tokens=4, text_bucket=128)
    tpred = TorchPredictor(tcfg, to_torch(jp), StubTokenizer(), max_new_tokens=4, text_bucket=128,
                           device="cpu")
    frames = np.random.default_rng(11).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)
    return jpred, tpred, frames


QUESTIONS = ["What is shown?", "What color is it?", "How many?"]


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.9, top_k=20, seed=3)],
                         ids=["greedy", "sampled"])
def test_three_turns_token_identical(predictors, sampling):
    """Three turns, the second cut by its budget (no EOS: the glue supplies
    the separator): every turn's tokens and answer JAX's; the resident cache
    grows, the prompt prefilled once (donors come from snapshots)."""
    jpred, tpred, frames = predictors
    kw = dict(video_uid="v", max_new_tokens=4, capacity=512, **sampling)
    js, ts = jpred.chat(frames, **kw), tpred.chat(frames, **kw)
    lens = []
    for i, q in enumerate(QUESTIONS):
        mnt = 3 if i == 1 else None
        assert ts.ask(q, max_new_tokens=mnt) == js.ask(q, max_new_tokens=mnt)
        assert ts.turn_tokens == js.turn_tokens
        assert ts._kv_len == js._kv_len
        lens.append(ts._kv_len)
    assert lens[0] < lens[1] < lens[2] <= ts.capacity
    assert ts._engine.prefix_prefills == 0
    assert ts._key in ts._engine._prefixes
    ts.close()
    js.close()
    assert ts._key not in ts._engine._prefixes and ts._engine._prefixes == {}
    with pytest.raises(RuntimeError):
        ts.ask("again?")


def test_follow_up_equals_from_scratch_prefill(predictors):
    """Turn 2 through the resident cache equals one engine request over
    [turn-1 prompt | turn-1 tokens | glue + question 2] prefilled from
    scratch."""
    from tdc_video_tpu_torch.models import lm as tlm
    from tdc_video_tpu_torch.serving.batching import DecodeEngine, Request

    _, tpred, frames = predictors
    cfg = tpred.cfg
    sess = tpred.chat(frames, video_uid="v", max_new_tokens=4, capacity=512)
    sess.ask(QUESTIONS[0])
    sess.ask(QUESTIONS[1])
    t1, t2 = sess.turn_tokens
    emb1, mask1, _ = tpred.pack_prompt(frames, QUESTIONS[0], video_uid="v")
    valid1 = int(mask1.sum())
    closed = t1[-1] in cfg.lm.eos_token_ids
    glue = tsess.encode_plain(tpred.tok, tsess.follow_up_text(cfg, QUESTIONS[1], closed))
    seq = torch.tensor([list(t1) + list(glue)])
    full = torch.cat([emb1[:, :valid1], tlm.embed_tokens(cfg.lm, tpred.params["lm"], seq,
                                                         cfg.dtype)], dim=1)
    eng = DecodeEngine(cfg, tpred.params, num_slots=1, capacity=512, attn_impl=tpred.attn_impl,
                       device="cpu")
    eng.submit(Request(embeds=full, attn_mask=np.ones((1, full.shape[1]), bool),
                       max_new_tokens=4, uid=0))
    (r,) = eng.run()
    assert list(r.tokens) == list(t2)
