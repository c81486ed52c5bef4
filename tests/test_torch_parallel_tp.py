"""The port's tensor-parallel serving and its frames over `data`, on two gloo
ranks (tests/torch_parallel_worker.py, mode "tp": one launch with a wall
limit, every rank one process on the CPU), against the JAX package's
unsharded runs on the same tdc_tiny weights in f32 (tests/test_parallel.py's
TestTPServing, TestTPEngine and TestShardedEncode):

* cli/serve.main --mesh 1x2 under torchrun's variables prints, on rank 0
  alone, what the one-process CLI prints (the answers and their tokens);
* generate_text_only on a 1x2 mesh, f32 and weight-only int8: JAX's
  unsharded tokens, prefill logits within 2e-4;
* act-quant prefill (int8 weights, s8 x s8): within f32 rounding (1e-5 of
  the logits' max) of the one-process port's only with the row amax reduce
  of the row-parallel projections; each rank's own amax moves them past it;
* DecodeEngine on the mesh in three modes and with an int8 KV cache:
  JAX's plain engine's tokens, num_kv_heads/2 heads a rank;
* StreamingEncoder on a 2x1 mesh: JAX's unsharded encode within 2e-5, and
  a chunk the data axis does not divide raises.

Every rank's tokens and logits are equal in every case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.models.quant import quantize_lm_int8 as j_quantize_lm_int8
from tdc_video_tpu.serving import batching as jb
from tdc_video_tpu.serving.generate import generate_text_only as j_generate_text_only
from tdc_video_tpu.serving.streaming import StreamingEncoder as JaxStreamingEncoder
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tmodel
from tdc_video_tpu_torch.cli import serve as tserve
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.models.quant import quantize_lm_int8
from test_builder import write_checkpoint
from torch_parallel_worker import Launch, serve_patches
from torch_parity import StubTokenizer, close, to_jax

N_NEW = 8
# f32 rounding of logits summed over two ranks' partial products
AQ_TOL = 1e-5
SERVE_QUESTIONS = ["What happens?", "Which color is it?"]


def _engine_cases():
    rng = np.random.default_rng(31)
    two = [rng.integers(2, 90, 9).tolist(), [4, 9, 17] * 4]
    base = dict(num_slots=2, capacity=64, chunk_tokens=4)
    return {
        "plain": {"engine": base, "prompts": two},
        "spec": {"engine": dict(base, spec_window=4), "prompts": two},
        "chunked": {"engine": dict(base, prefill_chunk=4), "prompts": two},
        "int8_kv": {"engine": dict(num_slots=1, capacity=64, kv_quant="int8"),
                    "prompts": [[5, 11, 29] * 3]},
    }


def _jax_prefill(cfg, lm, ids):
    emb = jlm.embed_tokens(cfg.lm, lm, ids, cfg.dtype)
    cache = jlm.init_kv_cache(cfg.lm, 1, ids.shape[1], cfg.dtype)
    return np.asarray(jlm.prefill(cfg.lm, lm, emb, jnp.ones(ids.shape, bool), cache,
                                  dtype=cfg.dtype)[0])


def _jax_engine(cfg, lm, case):
    eng = jb.DecodeEngine(cfg, {"lm": lm}, **case["engine"])
    spec = case["engine"].get("spec_window", 0)
    for ids in case["prompts"]:
        a = jnp.asarray(np.asarray(ids, np.int32)[None])
        eng.submit(jb.Request(embeds=jlm.embed_tokens(cfg.lm, lm, a, cfg.dtype),
                              attn_mask=jnp.ones(a.shape, bool), max_new_tokens=10,
                              uid=tuple(int(i) for i in ids),
                              prompt_ids=np.asarray(ids, np.int32) if spec else None))
    return {r.uid: [int(t) for t in r.tokens] for r in eng.run()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results and JAX's references, computed while the ranks
    run."""
    wd = tmp_path_factory.mktemp("tp")
    jcfg = jc.tdc_tiny()
    tp = tmodel.init_tdc(tc.tdc_tiny(), torch.Generator().manual_seed(0), "cpu")
    jp = to_jax(tp)
    ckpt = str(wd / "ckpt")
    write_checkpoint(ckpt, jc.tdc_tiny(), audio=False)
    rng = np.random.default_rng(3)
    s, d = jcfg.siglip.image_size, jcfg.dino.image_size
    serve_frames = rng.integers(0, 256, (4, 48, 64, 3), dtype=np.uint8)
    serve_argv = ["--model_path", ckpt, "--video", "clip.mp4", "--bert_tokenizer", "",
                  "--max_new_tokens", "4", "--slots", "2", "--max_frames", "4", "--device", "cpu"]
    for q in SERVE_QUESTIONS:
        serve_argv += ["--question", q]
    inputs = {
        "tdc": tp, "ids": torch.from_numpy(rng.integers(2, 90, (1, 9))),
        "engine_cases": _engine_cases(),
        "sig": rng.normal(0, 1, (8, s, s, 3)).astype(np.float32),
        "dino": rng.normal(0, 1, (8, d, d, 3)).astype(np.float32),
        "serve_frames": serve_frames, "serve_argv": serve_argv,
    }
    torch.save(inputs, wd / "inputs.pt")
    ranks = Launch("tp", 2, wd, wall_s=120.0)

    ids = jnp.asarray(inputs["ids"].numpy(), jnp.int32)
    mask = jnp.ones(ids.shape, bool)
    ref = {}
    for name, lm in (("float", jp["lm"]), ("int8", j_quantize_lm_int8(jp["lm"]))):
        gen = jax.jit(lambda p, i, m: j_generate_text_only(jcfg, p, i, m,
                                                           max_new_tokens=N_NEW))
        ref[name] = {"tokens": np.asarray(gen({"lm": lm}, ids, mask)),
                     "logits": _jax_prefill(jcfg, lm, ids)}
    ref["engine"] = {k: _jax_engine(jcfg, jp["lm"], c) for k, c in _engine_cases().items()}
    ref["encode"] = JaxStreamingEncoder(jcfg, jp, chunk_frames=8, device_prep=False)._encode(
        jp, jnp.asarray(inputs["sig"]), jnp.asarray(inputs["dino"]))
    ranks.wait()
    return inputs, ranks.results(), ref, wd


def _same_on_every_rank(res, *path):
    vals = []
    for r in res:
        v = r
        for k in path:
            v = v[k]
        vals.append(v)
    for v in vals[1:]:
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, vals[0]), path
        else:
            assert v == vals[0], path
    return vals[0]


def _printed(text):
    import re

    return re.sub(r"\d+\.\d+s", "Xs", text)


def test_serve_mesh_prints_the_one_process_answers(run, monkeypatch, capsys):
    inputs, res, _, _ = run
    for (mod, name), fn in serve_patches(inputs["serve_frames"]).items():
        monkeypatch.setattr(mod, name, fn)
    ref = tserve.run(tserve.parse_args(inputs["serve_argv"]), tokenizer=StubTokenizer())
    printed = capsys.readouterr().out
    rank0 = res[0]["serve"]
    assert rank0["answers"] == ref["answers"] and rank0["ids"] == ref["ids"]
    _same_on_every_rank(res, "serve", "ids")
    lines = [ln for ln in rank0["stdout"].splitlines() if not ln.startswith("mesh: 1x2")]
    assert _printed("\n".join(lines)) == _printed("\n".join(printed.splitlines()))
    assert "mesh: 1x2 over 2 ranks" in rank0["stdout"]
    assert res[1]["serve"]["stdout"] == ""  # rank 0 alone prints


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_tp_generate_matches_unsharded_jax(run, kind):
    _, res, ref, _ = run
    toks = _same_on_every_rank(res, kind, "tokens")
    logits = _same_on_every_rank(res, kind, "logits")
    np.testing.assert_array_equal(toks.numpy(), ref[kind]["tokens"])
    close(logits, ref[kind]["logits"], atol=2e-4, rtol=2e-4)
    # each rank holds half the query columns: 2 of the 4 heads of 16
    assert [r[kind]["q_cols"] for r in res] == [32, 32]


def test_tp_act_quant_needs_the_amax_reduce(run):
    """The one-process port's act-quant prefill is the reference: with the
    reduce the TP logits are it within f32 rounding; with each rank's own
    amax the row-parallel projections quantize with other scales and the
    logits move past that rounding.  Both stay within JAX's act-quant bound
    (0.08 of the max) of the float logits."""
    inputs, res, _, _ = run
    cfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    ids = inputs["ids"]
    mask = torch.ones(ids.shape, dtype=torch.bool)

    def prefill(lm, act_quant):
        emb = tlm.embed_tokens(cfg.lm, lm, ids, cfg.dtype)
        cache = tlm.init_kv_cache(cfg.lm, 1, ids.shape[1], cfg.dtype, "cpu")
        return tlm.prefill(cfg.lm, lm, emb, mask, cache, dtype=cfg.dtype, act_quant=act_quant)[0]

    one = prefill(quantize_lm_int8(inputs["tdc"]["lm"]), True)
    flt = prefill(inputs["tdc"]["lm"], False)
    scale = float(one.abs().max())
    with_r = _same_on_every_rank(res, "act_quant", "with_reduce")
    without = _same_on_every_rank(res, "act_quant", "without_reduce")
    d_with = float((with_r - one).abs().max()) / scale
    d_without = float((without - one).abs().max()) / scale
    assert d_with <= AQ_TOL, d_with
    assert d_without > 10 * AQ_TOL, d_without
    for got in (with_r, without):
        assert float((got - flt).abs().max()) / float(flt.abs().max()) <= 0.08


@pytest.mark.parametrize("case", ["plain", "spec", "chunked", "int8_kv"])
def test_tp_engine_matches_plain_jax(run, case):
    _, res, ref, _ = run
    got = _same_on_every_rank(res, "engine", case)
    assert got == ref["engine"][case]
    # the cache holds this rank's half of the 2 KV heads
    assert [r["engine"][case + "/kv_heads"] for r in res] == [1, 1]


def test_sharded_encode_matches_unsharded_jax(run):
    _, res, ref, _ = run
    ff, df = _same_on_every_rank(res, "encode", 0), _same_on_every_rank(res, "encode", 1)
    close(ff, ref["encode"][0], atol=2e-5, rtol=2e-5)
    close(df, ref["encode"][1], atol=2e-5, rtol=2e-5)
    assert ff.shape[0] == 8  # the whole chunk on every rank


def test_chunk_not_divisible_by_data_raises(run):
    _, res, _, _ = run
    assert [r["chunk_raises"] for r in res] == [True, True]


def test_make_mesh_raises_off_the_world_size_and_heads(run):
    """In a world of 2: a 2x2 mesh, and a model axis of 2 over 3 KV heads."""
    _, res, _, _ = run
    assert [r["mesh_raises"] for r in res] == [[True, True], [True, True]]
