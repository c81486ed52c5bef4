"""The port's continuous-batching DecodeEngine (serving/batching.py) against
the JAX package's, on the CPU in f32 with shared tdc_tiny weights: the same
request stream (two submitted, run, two more, run again: slot reuse across
runs) gives every uid identical tokens (tolerance 0) in each mode: greedy,
sampled, mixed, speculative, speculative-sampled, shared prefix, chunked
admission (with a near-capacity ragged first chunk) and the int8 KV cache.

Then the behaviour cases of tests/test_batching.py on the port alone,
against the port's solo greedy generation: cancellation, timeouts, a
raising on_tokens callback, streaming, prefix release, reset and the
capacity-truncated budget; and the one device-to-host read per chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.models import lm as jlm
from tdc_video_tpu.serving import batching as jb
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.models import lm as tlm
from tdc_video_tpu_torch.serving import batching as tb
from tdc_video_tpu_torch.serving.generate import generate_text_only
from torch_parity import StandInMesh, t, to_torch


@pytest.fixture(scope="module")
def setup():
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jp, to_torch(jp)


def _spec(ids, max_new=10, uid=None, pad=0, **kw):
    ids = np.asarray(ids, np.int32)
    return dict(ids=ids, max_new=max_new, uid=tuple(ids) if uid is None else uid, pad=pad, **kw)


def _request(pkg, params, s):
    """One request in either package from a spec: embeds of the ids padded
    with `pad` pad tokens (masked), prompt ids for drafting."""
    ids = np.concatenate([s["ids"], np.zeros(s["pad"], np.int32)])[None]
    mask = (np.arange(ids.shape[1]) < len(s["ids"]))[None]
    kw = {k: s[k] for k in ("temperature", "top_k", "top_p", "seed", "prefix_key", "prefix_len",
                            "timeout_s", "keep_prefix") if k in s}
    if pkg == "jax":
        cfg = jc.tdc_tiny()
        emb = jlm.embed_tokens(cfg.lm, params["lm"], jnp.asarray(ids), cfg.dtype)
        return jb.Request(embeds=emb, attn_mask=jnp.asarray(mask), max_new_tokens=s["max_new"],
                          uid=s["uid"], prompt_ids=s["ids"], **kw)
    cfg = tc.tdc_tiny()
    emb = tlm.embed_tokens(cfg.lm, params["lm"], t(ids), cfg.dtype)
    return tb.Request(embeds=emb, attn_mask=mask, max_new_tokens=s["max_new"], uid=s["uid"],
                      prompt_ids=s["ids"], **kw)


def _serve(pkg, params, waves, **engine_kw):
    """Each wave is submitted and drained with run(); returns {uid: tokens}
    and the engine."""
    if pkg == "jax":
        eng = jb.DecodeEngine(jc.tdc_tiny(), params, **engine_kw)
    else:
        eng = tb.DecodeEngine(tc.tdc_tiny(), params, device="cpu", **engine_kw)
    out = {}
    for wave in waves:
        for s in wave:
            eng.submit(_request(pkg, params, s))
        out.update({r.uid: list(r.tokens) for r in eng.run()})
    return out, eng


def _prompts(seed, n, lo=4, hi=14, vocab=90):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, int(rng.integers(lo, hi))) for _ in range(n)]


def _sampled(i):
    return dict(temperature=[0.8, 1.0, 1.3][i % 3], top_k=[50, 0, 10][i % 3],
                top_p=[1.0, 0.9, 0.8][i % 3], seed=11 + i)


def _shared(seed, n, head_len=9):
    rng = np.random.default_rng(seed)
    head = rng.integers(2, 90, head_len)
    return [np.concatenate([head, rng.integers(2, 90, int(rng.integers(2, 6)))])
            for _ in range(n)]


def _mode(name):
    """(waves of request specs, engine keyword arguments) of each mode."""
    ps = _prompts(100 + MODES.index(name), 4)
    plain = [_spec(p) for p in ps]
    if name == "greedy":
        return [plain[:2], plain[2:]], dict(num_slots=2, capacity=48, chunk_tokens=4)
    if name == "sampled":
        reqs = [_spec(p, **_sampled(i)) for i, p in enumerate(ps)]
        return [reqs[:2], reqs[2:]], dict(num_slots=2, capacity=48, chunk_tokens=4)
    if name == "mixed":
        reqs = [_spec(p, **(_sampled(i) if i % 2 else {})) for i, p in enumerate(ps)]
        return [reqs[:3], reqs[3:]], dict(num_slots=3, capacity=48, chunk_tokens=3)
    if name == "spec":
        reps = [np.array([4, 9, 17] * 4), np.array([5, 6, 7, 5, 6, 7, 5])]
        reqs = [_spec(p) for p in ps[:2] + reps]
        return [reqs[:2], reqs[2:]], dict(num_slots=2, capacity=48, chunk_tokens=3, spec_window=4)
    if name == "spec_sampled":
        reqs = [_spec(p, **(_sampled(i) if i != 1 else {})) for i, p in enumerate(ps)]
        return [reqs[:2], reqs[2:]], dict(num_slots=2, capacity=48, chunk_tokens=3, spec_window=4)
    if name == "shared_prefix":
        sh = _shared(41, 4)
        reqs = [_spec(p, prefix_key="v", prefix_len=9, pad=2 * (i % 2)) for i, p in enumerate(sh)]
        return [reqs[:3], reqs[3:]], dict(num_slots=2, capacity=48, chunk_tokens=4)
    if name == "chunked":
        long = _prompts(52, 3, 9, 20) + [np.random.default_rng(5).integers(2, 90, 43)]
        reqs = [_spec(p, max_new=8) for p in long]
        # the last prompt: 43 of capacity 48, 43 % 4 = 3 ragged tokens first
        return [reqs[:2], reqs[2:]], dict(num_slots=2, capacity=48, chunk_tokens=4,
                                          prefill_chunk=4)
    if name == "chunked_prefix":
        sh = _shared(42, 3, head_len=11)
        reqs = [_spec(p, prefix_key="v", prefix_len=11, **(_sampled(i) if i == 1 else {}))
                for i, p in enumerate(sh)]
        return [reqs], dict(num_slots=2, capacity=48, chunk_tokens=4, prefill_chunk=3)
    if name == "int8_kv":
        return [plain[:2], plain[2:]], dict(num_slots=2, capacity=48, chunk_tokens=4,
                                            kv_quant="int8")
    if name == "int8_kv_spec_prefix":
        sh = _shared(43, 3)
        reqs = [_spec(p, prefix_key="v", prefix_len=9) for p in sh]
        return [reqs], dict(num_slots=3, capacity=48, chunk_tokens=4, kv_quant="int8",
                            spec_window=4)
    raise KeyError(name)


MODES = ["greedy", "sampled", "mixed", "spec", "spec_sampled", "shared_prefix", "chunked",
         "chunked_prefix", "int8_kv", "int8_kv_spec_prefix"]


@pytest.mark.parametrize("mode", MODES)
def test_engine_token_identical_to_jax(setup, mode):
    jp, tp = setup
    waves, kw = _mode(mode)
    ref, jeng = _serve("jax", jp, waves, **kw)
    out, teng = _serve("torch", tp, waves, **kw)
    assert out == ref
    assert len(out) == sum(len(w) for w in waves)
    assert (teng.prefix_prefills, teng.prefill_chunks) == (jeng.prefix_prefills,
                                                           jeng.prefill_chunks)
    if "prefix" in mode:  # once a wave: the donor goes when its wave drains
        assert teng.prefix_prefills == len(waves)
    if mode == "chunked":
        assert len(out[waves[1][1]["uid"]]) == 1 + (48 - 43)  # budget cut to capacity


def test_mesh_raises(setup):
    """A mesh whose model axis does not divide the 2 KV heads raises before
    any cache is made (the TP engine itself: tests/test_torch_parallel_tp.py)."""
    with pytest.raises(ValueError, match="KV heads"):
        tb.DecodeEngine(tc.tdc_tiny(), setup[1], mesh=StandInMesh(n_model=4), device="cpu")


# -- behaviour, on the port ---------------------------------------------------


def _solo(tp, ids, max_new):
    """The port's solo greedy tokens, cut after an EOS (or at a pad)."""
    cfg = tc.tdc_tiny()
    ids = np.asarray(ids, np.int32)[None]
    out = generate_text_only(cfg, tp, t(ids), torch.ones(ids.shape, dtype=torch.bool),
                             max_new_tokens=max_new)[0].tolist()
    toks = []
    for x in out:
        toks.append(x)
        if x in cfg.lm.eos_token_ids:
            break
        if x == cfg.lm.pad_token_id and len(toks) > 1:
            toks.pop()
            break
    return toks


def _engine(tp, **kw):
    return tb.DecodeEngine(tc.tdc_tiny(), tp, device="cpu", **kw)


def _req(tp, ids, max_new, uid=None, **kw):
    return _request("torch", tp, _spec(ids, max_new, uid, **kw))


def test_cancel_queued_never_prefills(setup):
    tp = setup[1]
    keep_ids, kill_ids = _prompts(8, 2)
    eng = _engine(tp, num_slots=1, capacity=64, chunk_tokens=4)
    eng.submit(_req(tp, keep_ids, 6))
    eng.submit(_req(tp, kill_ids, 6, uid="victim"))
    assert eng.cancel("victim") and not eng.cancel("no-such-uid")
    done = {r.uid: r for r in eng.run()}
    assert len(done) == 2
    v = done["victim"]
    assert v.cancelled and v.done and v.tokens == []
    want = _solo(tp, keep_ids, 6)
    assert done[tuple(np.asarray(keep_ids, np.int32))].tokens[: len(want)] == want


def test_cancel_inflight_from_callback(setup):
    tp = setup[1]
    a_ids, b_ids = _prompts(9, 2)
    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=2)
    state = {"cancelled": False}

    def on_tokens(req, new):
        if req.uid == "a" and len(req.tokens) >= 3 and not state["cancelled"]:
            state["cancelled"] = eng.cancel("b")

    eng.on_tokens = on_tokens
    eng.submit(_req(tp, a_ids, 12, uid="a"))
    eng.submit(_req(tp, b_ids, 50, uid="b"))
    done = {r.uid: r for r in eng.run()}
    assert state["cancelled"] and done["b"].cancelled and done["b"].done
    assert len(done["b"].tokens) < 50
    want = _solo(tp, a_ids, 12)
    assert done["a"].tokens[: len(want)] == want and not done["a"].cancelled
    assert not eng._active_host.any() and not bool(eng._active.any())


def test_timeout_expires_queued_and_inflight(setup):
    tp = setup[1]
    ok_ids, late_ids = _prompts(10, 2)
    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=2)
    eng.submit(_req(tp, ok_ids, 6, uid="ok"))
    eng.submit(_req(tp, late_ids, 6, uid="late", timeout_s=0.0))
    done = {r.uid: r for r in eng.run()}
    assert done["late"].timed_out and done["late"].done and not done["late"].cancelled
    assert done["late"].tokens == [] and not done["ok"].timed_out
    want = _solo(tp, ok_ids, 6)
    assert done["ok"].tokens[: len(want)] == want


def test_on_tokens_exception_does_not_corrupt(setup):
    tp = setup[1]
    prompts = _prompts(11, 2)

    def bomb(req, new):
        raise RuntimeError("client went away")

    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=4, on_tokens=bomb)
    for ids in prompts:
        eng.submit(_req(tp, ids, 8))
    done = {r.uid: r.tokens for r in eng.run()}
    assert len(done) == 2
    assert eng.on_tokens_errors and all(isinstance(e, RuntimeError) for e in eng.on_tokens_errors)
    for ids in prompts:
        want = _solo(tp, ids, 8)
        assert done[tuple(np.asarray(ids, np.int32))][: len(want)] == want


@pytest.mark.parametrize("spec_window", [0, 3], ids=["plain", "spec"])
def test_on_tokens_streams_every_token_once(setup, spec_window):
    tp = setup[1]
    prompts = _prompts(5, 2)
    deltas, calls = {}, []

    def on_tokens(req, new):
        assert new
        deltas.setdefault(req.uid, []).extend(new)
        calls.append(req.uid)

    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=4, on_tokens=on_tokens,
                  spec_window=spec_window)
    for ids in prompts:
        eng.submit(_req(tp, ids, 10))
    done = eng.run()
    for r in done:
        assert deltas[r.uid] == r.tokens
        if spec_window == 0:
            assert calls.count(r.uid) >= 2  # the first token, then the harvests


def test_prefix_released_after_last_consumer(setup):
    tp = setup[1]
    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=4)
    for ids in _shared(41, 3, head_len=8):
        eng.submit(_req(tp, ids, 6, prefix_key="vid0", prefix_len=8))
    done = eng.run()
    assert len(done) == 3 and eng.prefix_prefills == 1
    assert eng._prefixes == {}


def test_reset_clears_sampling_state(setup):
    tp = setup[1]
    ids = _prompts(19, 1)[0]
    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=4)
    eng.submit(_req(tp, ids, 8, uid="s", temperature=1.3, seed=9))
    eng.run()
    eng.reset()
    assert not bool(eng._temp.any()) and not bool(eng._genidx.any())
    eng.submit(_req(tp, ids, 8))
    a = {r.uid: r.tokens for r in eng.run()}
    fresh = _engine(tp, num_slots=2, capacity=64, chunk_tokens=4)
    fresh.submit(_req(tp, ids, 8))
    assert a == {r.uid: r.tokens for r in fresh.run()}


def test_budget_truncated_to_capacity(setup):
    tp = setup[1]
    eng = _engine(tp, num_slots=2, capacity=24, chunk_tokens=4)
    eng.submit(_req(tp, np.random.default_rng(7).integers(2, 50, 18), 64))
    done = eng.run()
    assert len(done) == 1 and len(done[0].tokens) <= 1 + (24 - 18)


def test_prefill_terminated_queue_drains(setup):
    tp = setup[1]
    eng = _engine(tp, num_slots=1, capacity=32, chunk_tokens=4)
    uids = []
    for i, ids in enumerate(_prompts(8, 3)):
        r = _req(tp, ids, 1, uid=i)
        uids.append(r.uid)
        eng.submit(r)
    done = eng.run()
    assert sorted(r.uid for r in done) == uids and all(len(r.tokens) == 1 for r in done)


def test_one_read_per_chunk(setup, monkeypatch):
    """Each decode chunk harvests with one device-to-host read, and nothing
    else in the loop reads the device state back."""
    tp = setup[1]
    reads = []
    real = tb.DecodeEngine._read
    monkeypatch.setattr(tb.DecodeEngine, "_read",
                        lambda self, *a: reads.append(len(a)) or real(self, *a))
    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=4)
    for ids in _prompts(3, 3):
        eng.submit(_req(tp, ids, 9))
    eng.run()
    assert len(reads) == eng.steps > 0
    assert len(eng.chunk_spans) == eng.steps and sum(n for _, _, n in eng.chunk_spans) > 0


# -- randomized streams (tests/test_batching.py:488 and :704) -----------------


def _drained(eng):
    """Nothing stranded or leaked: no queue, no half-built prefill, no
    request in a slot, no active slot, no stored prefix."""
    assert eng._queue == [] and eng._pending is None
    assert all(r is None for r in eng._requests)
    assert not eng._active_host.any() and not bool(eng._active.any())
    assert eng._prefixes == {}


@pytest.mark.parametrize("mode", [{}, dict(prefill_chunk=4), dict(spec_window=3, prefill_chunk=4),
                                  dict(spec_window=4, kv_quant="int8")],
                         ids=["plain", "chunked", "spec+chunked", "spec+kv8"])
def test_random_staggered_stream(setup, mode):
    """Random prompt lengths and budgets, submitted two then one per run():
    every request returns once with its solo greedy tokens (int8 KV: a
    budget-respecting stream) and the engine drains clean between runs."""
    tp = setup[1]
    rng = np.random.default_rng(77)
    # a tight alphabet, so that some answers repeat or stop early
    prompts = [rng.integers(2, 40, int(rng.integers(3, 14))) for _ in range(8)]
    budgets = [int(rng.integers(1, 9)) for _ in prompts]
    eng = _engine(tp, num_slots=3, capacity=32, chunk_tokens=2, **mode)
    done, submitted = [], 0
    while submitted < len(prompts):
        for _ in range(2 if submitted == 0 else 1):
            if submitted < len(prompts):
                eng.submit(_req(tp, prompts[submitted], budgets[submitted], uid=submitted))
                submitted += 1
        done += eng.run()
        _drained(eng)
    assert sorted(r.uid for r in done) == list(range(len(prompts)))
    for r in done:
        assert 1 <= len(r.tokens) <= budgets[r.uid]
        if not mode.get("kv_quant"):
            want = _solo(tp, prompts[r.uid], budgets[r.uid])
            assert r.tokens[: len(want)] == want


@pytest.mark.parametrize("mode", [dict(prefill_chunk=4), dict(spec_window=3)],
                         ids=["chunked", "spec"])
def test_no_request_stranded_under_adversarial_stream(setup, mode):
    """Random arrivals, shared-prefix pairs, cancels of queued requests and
    instant timeouts: every request returns exactly once, within its
    budget, and the engine ends drained with no prefix held."""
    tp = setup[1]
    rng = np.random.default_rng(123)
    shared = rng.integers(2, 90, 12)
    eng = _engine(tp, num_slots=2, capacity=64, chunk_tokens=2, **mode)
    n, returned, submitted = 14, [], 0
    while submitted < n:
        for _ in range(2 if submitted == 0 else 1):
            if submitted >= n:
                break
            uid = f"r{submitted}"
            kw = {}
            if submitted % 3 == 0 and not mode.get("spec_window"):
                ids = np.concatenate([shared, rng.integers(2, 90, 3)])
                kw = dict(prefix_key="vid", prefix_len=len(shared))
            else:
                ids = rng.integers(2, 90, int(rng.integers(3, 14)))
            if submitted % 5 == 1:
                kw["timeout_s"] = 0.0
            eng.submit(_req(tp, ids, int(rng.integers(1, 8)), uid=uid, **kw))
            if submitted % 4 == 2:
                eng.cancel(uid)
            submitted += 1
        returned += eng.run()
    returned += eng.run()  # nothing left: a no-op
    uids = [r.uid for r in returned]
    assert sorted(uids) == sorted(f"r{i}" for i in range(n)) and len(set(uids)) == n
    _drained(eng)
    for r in returned:
        assert r.done and len(r.tokens) <= r.max_new_tokens
        i = int(r.uid[1:])
        if i % 4 == 2:
            assert r.cancelled and r.tokens == []
        elif i % 5 == 1:
            assert r.timed_out and r.tokens == []


# -- the chunk's state stays in place (the card replays it from a CUDA graph) --

_SLOT_STATE = ("_last_tok", "_active", "_budget_dev", "_temp", "_topk", "_topp", "_seed",
               "_genidx", "_chunk_out")

_GROUPS = {  # engine keyword arguments of each scenario
    "two_groups": dict(num_slots=2, capacity=64, chunk_tokens=3),
    "admit_between_chunks": dict(num_slots=2, capacity=64, chunk_tokens=2),
    "cancel": dict(num_slots=2, capacity=64, chunk_tokens=2),
    "chunked": dict(num_slots=2, capacity=64, chunk_tokens=2, prefill_chunk=4),
}


def _group(eng, tp, scenario, seed):
    """One group of requests through `eng`: greedy and sampled rows mixed;
    `admit_between_chunks` submits a request from the first harvest, `cancel`
    cancels one in flight there.  Returns {uid: (tokens, cancelled)}."""
    prompts = _prompts(200 + seed, 3, 5, 21 if scenario == "chunked" else 12)
    specs = [dict(uid="a"), dict(uid="b", **_sampled(seed)), dict(uid="c")]
    late = scenario == "admit_between_chunks"
    hooked = {"done": False}

    def on_tokens(req, new):
        if req.uid != "a" or len(req.tokens) < 2 or hooked["done"]:
            return
        hooked["done"] = True
        if late:
            eng.submit(_req(tp, prompts[2], 7, **specs[2]))
        elif scenario == "cancel":
            assert eng.cancel("b")

    eng.on_tokens = on_tokens
    for ids, kw in list(zip(prompts, specs))[:2 if late else 3]:
        eng.submit(_req(tp, ids, 7 if late else 9, **kw))
    done = {r.uid: (list(r.tokens), r.cancelled) for r in eng.run()}
    assert hooked["done"] and len(done) == 3
    return done


@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16_kv", "int8_kv"])
def test_chunk_state_keeps_its_storage(setup, kv):
    """The cache (mask and lengths too) and the per-slot tensors keep their
    storage through chunks, a reset and a second group: a graph captured
    over them stays valid.  On the CPU every chunk runs eagerly."""
    tp = setup[1]
    eng = _engine(tp, kv_quant=kv, **_GROUPS["two_groups"])

    def ptrs():
        return ({k: v.data_ptr() for k, v in eng.cache.items()}
                | {n: getattr(eng, n).data_ptr() for n in _SLOT_STATE})

    before = ptrs()
    _group(eng, tp, "two_groups", 0)
    assert ptrs() == before and eng.steps > 0
    eng.reset()
    assert ptrs() == before
    assert not bool(eng._active.any()) and bool((eng._topp == 1).all())
    _group(eng, tp, "two_groups", 1)
    assert ptrs() == before
    assert eng._graphs is None and eng.graph_captures == eng.graph_replays == 0


@pytest.mark.parametrize("scenario", list(_GROUPS))
def test_reused_engine_matches_fresh(setup, scenario):
    """An engine reset between two groups gives each group the tokens a
    fresh engine gives it: across admission between chunks, cancellation
    in flight and chunked admission, greedy and sampled rows mixed."""
    tp = setup[1]
    kw = _GROUPS[scenario]
    eng = _engine(tp, **kw)
    first = _group(eng, tp, scenario, 0)
    eng.reset()
    second = _group(eng, tp, scenario, 1)
    assert first == _group(_engine(tp, **kw), tp, scenario, 0)
    assert second == _group(_engine(tp, **kw), tp, scenario, 1)
    if scenario == "cancel":
        assert first["b"][1] and second["b"][1]


def test_eager_chunks_marked_in_dispatch_spans(setup):
    """Each engine.dispatch span says whether its chunk replayed a graph:
    0 for every chunk on the CPU."""
    from tdc_video_tpu_torch.utils import profiling as P

    tp = setup[1]
    eng = _engine(tp, **_GROUPS["two_groups"])
    with P.recording():
        _group(eng, tp, "two_groups", 0)
    got = [s["attrs"]["graph"] for s in P.collect()["spans"] if s["name"] == "engine.dispatch"]
    assert got == [0] * eng.steps and eng.steps > 0
