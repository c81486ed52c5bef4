"""The port's TDCPredictor over a mesh and tensor-parallel generation on a
2x2 mesh, on gloo ranks (tests/torch_parallel_worker.py: 4 ranks of mode
"tp22" and, at the same time, 3 ranks of mode "round", each launch with a
wall limit), against the JAX package's one-device runs on the same
tdc_tiny weights in f32 (tests/test_parallel.py's TestTPServing and
TestMeshPredictor):

* generate_text_only on 2x2 (TP over model, replicas over data), f32 and
  weight-only int8: JAX's unsharded tokens, prefill logits within 2e-4;
* the predictor on 2x2 (frames over data, the LM over model): answer and
  answer_many token-identical to JAX's one-device predictor;
* the predictor on 3x1: the frame bucket (8 for 5 frames) rounded up to 9,
  the pad frames masked, the answer JAX's.

Every rank's tokens and answers are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.eval.runner import TDCPredictor as JaxPredictor
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.models.quant import quantize_lm_int8 as j_quantize_lm_int8
from tdc_video_tpu.serving.generate import generate_text_only as j_generate_text_only
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tmodel
from test_torch_e2e import JaxStubTokenizer
from torch_parallel_worker import Launch
from torch_parity import close, to_jax

QUESTIONS = ["What is shown?", "What color dominates?"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    wd = tmp_path_factory.mktemp("pred")
    tp = tmodel.init_tdc(tc.tdc_tiny(), torch.Generator().manual_seed(1), "cpu")
    jp = to_jax(tp)
    rng = np.random.default_rng(11)
    inputs = {"tdc": tp, "ids": torch.from_numpy(rng.integers(2, 90, (1, 9))),
              "frames": rng.integers(0, 255, (5, 48, 64, 3)).astype(np.uint8),
              "questions": QUESTIONS}
    torch.save(inputs, wd / "inputs.pt")
    launches = [Launch("tp22", 4, wd, wall_s=120.0), Launch("round", 3, wd, wall_s=120.0)]

    jcfg = dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32)
    ids = jnp.asarray(inputs["ids"].numpy(), jnp.int32)
    mask = jnp.ones(ids.shape, bool)
    ref = {}
    for name, lm in (("float", jp["lm"]), ("int8", j_quantize_lm_int8(jp["lm"]))):
        gen = jax.jit(lambda p, i, m: j_generate_text_only(jcfg, p, i, m, max_new_tokens=8))
        emb = jlm.embed_tokens(jcfg.lm, lm, ids, jcfg.dtype)
        cache = jlm.init_kv_cache(jcfg.lm, 1, ids.shape[1], jcfg.dtype)
        ref[name] = {"tokens": np.asarray(gen({"lm": lm}, ids, mask)),
                     "logits": np.asarray(jlm.prefill(jcfg.lm, lm, emb, mask, cache,
                                                      dtype=jcfg.dtype)[0])}
    jpred = JaxPredictor(jcfg, jp, JaxStubTokenizer(), max_new_tokens=4, text_bucket=128)
    ref["answer"] = jpred.answer(inputs["frames"], QUESTIONS[0], video_uid="v")
    ref["answer_many"] = jpred.answer_many(inputs["frames"], QUESTIONS, video_uid="v",
                                           num_slots=2)
    for launch in launches:
        launch.wait()
    return launches[0].results(), launches[1].results(), ref


def _same(res, key):
    vals = [r[key] for r in res]
    for v in vals[1:]:
        assert v.keys() == vals[0].keys()
        for k in v:
            same = torch.equal(v[k], vals[0][k]) if isinstance(v[k], torch.Tensor) \
                else v[k] == vals[0][k]
            assert same, (key, k)
    return vals[0]


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_tp_generate_2x2_matches_unsharded_jax(run, kind):
    res, _, ref = run
    got = _same(res, kind)
    np.testing.assert_array_equal(got["tokens"].numpy(), ref[kind]["tokens"])
    close(got["logits"], ref[kind]["logits"], atol=2e-4, rtol=2e-4)
    assert got["q_cols"] == 32  # 2 of the 4 query heads of 16 on every rank


def test_mesh_predictor_matches_jax(run):
    res, _, ref = run
    got = _same(res, "predict")
    assert got["answer"] == ref["answer"]
    assert got["answer_many"] == ref["answer_many"]
    assert got["T"] == 8 and got["feat_frames"] == 8 and got["valid_frames"] == 5
    assert got["q_cols"] == 32  # the predictor cut the LM to this rank's shard


def test_bucket_not_divisible_by_data_axis(run):
    """3 data ranks do not divide the bucket of 8: it becomes 9, the pad
    frames masked, and the answers stay JAX's one-device answers."""
    _, res, ref = run
    got = _same(res, "predict")
    assert got["T"] == 9 and got["feat_frames"] == 9 and got["valid_frames"] == 5
    assert got["answer"] == ref["answer"]
    assert got["answer_many"] == ref["answer_many"]
    assert got["q_cols"] == 64  # a model axis of 1: the whole LM
