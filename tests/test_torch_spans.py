"""The port's span recorder (utils/profiling.py) on tdc_tiny, on the CPU: off
it records nothing and opens no profiler range; under recording() answer,
answer_many and two Trainer.train_step calls record the span tree of each
layer boundary with one request id a request; the engine's span attrs agree
with DecodeEngine's own; every caller's encode_frames opens one `encode`
over the towers; table() sums the launch records; under trace() every span is a user annotation of
the Chrome trace, nested as recorded; idle_by_span keys a synthetic trace's
gaps by span and op; a new profiler session starts a fresh recording.  On
the card only: device intervals are positive and the launch records match
flash_attention.launches."""

import dataclasses
import json
import tempfile

import numpy as np
import pytest
import torch

from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.eval.runner import TDCPredictor
from tdc_video_tpu_torch.model import init_tdc
from tdc_video_tpu_torch.ops.audio import second_groups
from tdc_video_tpu_torch.utils import profiling as P
from torch_stub_tokenizer import StubTokenizer

QUESTIONS = ["What happens?", "Which color is on the left?", "Why?"]

ANSWER_TREE = [("answer", None), ("encode.preprocess", "answer"), ("encode", "answer"),
               ("encode.dino", "encode"), ("encode.siglip", "encode"), ("encode.sva", "encode"),
               ("compress", "answer"), ("compress.segment", "compress"), ("prefill", "answer"),
               ("decode", "answer")]


@pytest.fixture(scope="module")
def pred():
    cfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    params = init_tdc(cfg, torch.Generator().manual_seed(0), device="cpu")
    return TDCPredictor(cfg, params, StubTokenizer(), max_new_tokens=6, text_bucket=128,
                        device="cpu", device_preprocess=True)


@pytest.fixture(scope="module")
def frames():
    f = np.random.default_rng(3).integers(0, 256, (6, 48, 64, 3), dtype=np.uint8)
    f[3:, :, :32] = 255 - f[3:, :, :32]
    return f


def _tree(spans):
    return [(s["name"], s["parent_name"]) for s in spans]


def test_off_records_nothing_and_opens_no_range(pred, frames, monkeypatch):
    with P.recording():
        pass  # an empty recording, left in place

    def forbidden(*a, **k):
        raise AssertionError("the recorder worked while off")

    monkeypatch.setattr(P, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(P._Span, "__init__", forbidden)
    assert P.span("x", device=True) is P.span("y") and not P.span("x")
    pred.answer(frames, QUESTIONS[0])
    monkeypatch.undo()
    assert P.collect() == {"spans": [], "counters": {}, "launches": []}


@pytest.mark.parametrize("inside", [False, True], ids=["outside", "inside"])
def test_profiler_flag_is_the_profilers_state(inside):
    """The recorder's check (torch.autograd.profiler._is_profiler_enabled)
    agrees with the profiler's own state, and a span records exactly when
    a session is active."""
    def look():
        assert P._autograd_profiler._is_profiler_enabled == torch.autograd._profiler_enabled()
        with P.span("probe") as sp:
            return bool(sp)

    if inside:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert look()
    else:
        assert not look()


def test_answer_records_the_span_tree(pred, frames):
    with P.recording():
        pred.answer(frames, QUESTIONS[0])
    got = P.collect()["spans"]
    assert _tree(got) == ANSWER_TREE
    assert {s["request"] for s in got} == {"1"}
    by = {s["name"]: s for s in got}
    assert by["answer"]["attrs"]["frames"] == 6 and by["encode.dino"]["attrs"]["frames"] == 8
    assert by["decode"]["attrs"]["steps"] == pred.stats.decode_steps
    assert by["compress"]["attrs"]["rows"] > by["compress"]["attrs"]["visual_rows"] > 0
    assert all(s["host_ms"] >= 0 and s["device_ms"] is None for s in got)


def test_answer_many_records_the_engine(pred, frames):
    with P.recording():
        pred.answer_many(frames, QUESTIONS, video_uid="clip", num_slots=2,
                         prefix_share_threshold=16)
    got = P.collect()
    spans = got["spans"]
    assert got["counters"] == {}
    eng = next(reversed(pred._engine_cache.values()))
    names = [s["name"] for s in spans]
    assert names[0] == "answer_many" and names.count("encode") == 1  # the towers run once
    assert names.count("compress") == 3
    admits = [s for s in spans if s["name"] == "engine.admit"]
    assert [s["request"] for s in admits] == ["1/0", "1/1", "1/2"]
    assert all(s["parent_name"] == "answer_many" for s in admits)
    kids = {(s["name"], s["parent_name"]) for s in spans if s["name"].startswith("engine.")}
    assert kids == {("engine.admit", "answer_many"), ("engine.prefill_prefix", "engine.admit"),
                    ("engine.extend_suffix", "engine.admit"), ("engine.chunk", "answer_many"),
                    ("engine.dispatch", "engine.chunk"), ("engine.harvest", "engine.chunk")}
    assert names.count("engine.prefill_prefix") == eng.prefix_prefills == 1
    assert names.count("engine.chunk") == names.count("engine.dispatch") == eng.steps == \
        len(eng.chunk_spans)
    harvests = [s["attrs"]["slot_steps"] for s in spans if s["name"] == "engine.harvest"]
    assert harvests == [n for _, _, n in eng.chunk_spans] and sum(harvests) > 0
    reused = [s["attrs"]["prefix_rows_reused"] for s in admits]
    prefix = next(s for s in spans if s["name"] == "engine.prefill_prefix")["attrs"]["rows"]
    assert reused == [0, prefix, prefix]
    suffix = {s["parent"]: s["attrs"]["rows"] for s in spans if s["name"] == "engine.extend_suffix"}
    for s in admits:  # each prompt's valid rows: the shared prefix and its own suffix
        assert s["attrs"]["rows_prefilled"] + s["attrs"]["prefix_rows_reused"] == \
            prefix + suffix[s["index"]]
    assert all(s["attrs"]["queue_wait_s"] >= 0 for s in admits)


def _audio_batch(cfg, seed, T=4, L=24):
    rng = np.random.default_rng(seed)
    s, d = cfg.siglip.image_size, cfg.dino.image_size
    labels = np.full((1, L), -100, np.int32)
    labels[:, 10:] = rng.integers(2, 100, (1, L - 10))
    keep = np.zeros(10, np.int64)
    keep[[0, 2, 5, 7]] = 1
    f, p, g = (x[None] for x in second_groups(keep))
    return {"input_ids": rng.integers(2, 100, (1, L)).astype(np.int32), "labels": labels,
            "image_pos": np.full((1,), 5, np.int32), "text_len": np.full((1,), L, np.int32),
            "has_image": np.ones((1,), bool),
            "siglip_px": rng.normal(0, 1, (1, T, s, s, 3)).astype(np.float32),
            "dino_px": rng.normal(0, 1, (1, T, d, d, 3)).astype(np.float32),
            "frame_mask": np.ones((1, T), bool),
            "audio_windows": (0.1 * rng.normal(size=(1, 1, 160000))).astype(np.float32),
            "audio_wmask": np.ones((1, 1, 160000), bool), "audio_frame_of_sec": f,
            "audio_group_pos": p, "audio_group_size": g, "audio_sec_valid": np.ones((1, 10), bool)}


def test_train_steps_record_the_trainers_phases():
    """Two micro-steps with accumulation 2: each step's batch, forward and
    backward, one optimizer update; the audio encode under the forward and
    again under the backward (its checkpoint's recomputation)."""
    from tdc_video_tpu_torch.train.trainer import Trainer, TrainConfig

    cfg = dataclasses.replace(tc.tdc_tiny(audio=True), compress_dtype=torch.float32)
    params = init_tdc(cfg, torch.Generator().manual_seed(0), device="cpu")
    with tempfile.TemporaryDirectory() as out:
        tcfg = TrainConfig(gradient_accumulation_steps=2, model_max_length=48, max_visual_len=24,
                           report_to="none", output_dir=out, learning_rate=1e-3)
        tr = Trainer(cfg, tcfg, params, total_steps=2, device="cpu")
        with P.recording():
            for i in range(2):
                tr.train_step(_audio_batch(cfg, i))
    spans = P.collect()["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["request"] for s in steps] == ["1", "2"] and steps[0]["parent"] is None
    top = [(s["name"], s["request"]) for s in spans if s["parent_name"] == "train.step"]
    assert top == [("train.batch", "1"), ("train.forward", "1"), ("train.backward", "1"),
                   ("train.batch", "2"), ("train.forward", "2"), ("train.backward", "2"),
                   ("train.optimizer", "2")]
    audio = [(s["parent_name"], s["attrs"]["seconds"]) for s in spans
             if s["name"] == "encode.audio"]
    assert audio == [("train.forward", 10), ("train.backward", 10)] * 2
    fwd = {(s["name"], s["parent_name"]) for s in spans
           if s["parent_name"] in ("train.forward", "encode", "compress")}
    assert fwd == {("encode.audio", "train.forward"), ("encode", "train.forward"),
                   ("compress", "train.forward"), ("encode.dino", "encode"),
                   ("encode.siglip", "encode"), ("encode.sva", "encode"),
                   ("compress.segment", "compress")}


def test_encode_frames_opens_encode_for_every_caller(pred):
    """A caller with no span of its own (the streaming encoder, activation
    dumps) still gets the towers' spans under one `encode` root."""
    from tdc_video_tpu_torch.model import encode_frames

    cfg, g = pred.cfg, torch.Generator().manual_seed(1)
    sig = torch.randn((2, cfg.siglip.image_size, cfg.siglip.image_size, 3), generator=g)
    dino = torch.randn((2, cfg.dino.image_size, cfg.dino.image_size, 3), generator=g)
    with P.recording():
        encode_frames(cfg, pred.params, sig, dino)
    assert _tree(P.collect()["spans"]) == [("encode", None), ("encode.dino", "encode"),
                                           ("encode.siglip", "encode"), ("encode.sva", "encode")]


def test_table_sums_the_launch_records():
    q, k = torch.empty((1, 64, 4, 16)), torch.empty((1, 64, 2, 16))
    with P.recording():
        with P.span("outer"):
            for _ in range(3):
                P.launch("flash_kernel", q, k, True, 0, True)
            P.launch("flash_dq_kernel", q, k, True, 32)
    lines = P.table(P.collect()).splitlines()
    assert lines[-2:] == ["launch flash_kernel q [1, 64, 4, 16] k [1, 64, 2, 16] causal lse x3",
                          "launch flash_dq_kernel q [1, 64, 4, 16] k [1, 64, 2, 16] causal "
                          "q_offset 32 x1"]
    assert lines[1].split()[:2] == ["outer", "1"]


def test_trace_nests_the_spans_as_recorded(pred, frames, tmp_path):
    with P.trace(str(tmp_path)):
        pred.answer(frames, QUESTIONS[1])
    with open(tmp_path / "trace.json") as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    with open(tmp_path / "spans.json") as fh:
        spans = json.load(fh)["spans"]
    assert _tree(spans) == ANSWER_TREE
    ann = {}
    for e in events:
        ann.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    seen = {}
    iv = []
    for s in spans:  # the k-th span of a name is the k-th annotation of it
        k = seen[s["name"]] = seen.get(s["name"], -1) + 1
        iv.append(sorted(ann[s["name"]])[k])
    for s, (a, b) in zip(spans, iv):
        if s["parent"] is not None:
            pa, pb = iv[s["parent"]]
            assert pa <= a and b <= pb, (s["name"], s["parent_name"])


def test_idle_by_span_keys_gaps_by_span_and_op(tmp_path):
    def x(name, cat, ts, end):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": end - ts}

    events = [x("A", "user_annotation", 0, 100), x("B", "user_annotation", 25, 60),
              x("op1", "cpu_op", 5, 25), x("op2", "cpu_op", 50, 60),
              x("k", "kernel", 0, 10), x("k", "kernel", 30, 40), x("c", "gpu_memcpy", 70, 80),
              x("k", "kernel", 95, 100), x("k", "kernel", 96, 99)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = P.idle_by_span(str(path))
    assert r["busy_s"] == pytest.approx(35e-6) and r["idle_s"] == pytest.approx(65e-6)
    assert r["by_span"] == [["A", pytest.approx(35e-6)], ["B", pytest.approx(30e-6)]]
    assert dict((k, v) for k, v in r["by_span_op"]) == {
        "B/op2": pytest.approx(30e-6), "A/op1": pytest.approx(20e-6),
        "A/(no op)": pytest.approx(15e-6)}
    assert P.main([str(path)]) == 0


@pytest.mark.parametrize("between", ["collect", "span"])
def test_new_profiler_session_starts_a_fresh_recording(between):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        with P.span("first"):
            P.count("n")
    if between == "collect":
        assert [s["name"] for s in P.collect()["spans"]] == ["first"]
    else:
        with P.span("window"):  # what a benchmark's untraced window does
            pass
    with torch.profiler.profile(activities=acts):
        with P.span("second"):
            P.count("n", 2)
    got = P.collect()
    assert [s["name"] for s in got["spans"]] == ["second"] and got["counters"] == {"n": 2}


@pytest.mark.cuda
def test_device_intervals_and_launch_records_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from tdc_video_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 512, 8, 128), device="cuda", dtype=torch.bfloat16, generator=g)
    k = torch.randn((1, 512, 2, 128), device="cuda", dtype=torch.bfloat16, generator=g)
    before = dict(fa.launches)
    with P.recording():
        with P.span("outer", device=True):
            for _ in range(3):
                fa.flash_kernel(q, k, k, 128 ** -0.5, causal=True)
            fa.full_attention(q[:, :256], q[:, :256], q[:, :256], 128 ** -0.5)
    got = P.collect()
    assert got["spans"][0]["device_ms"] > 0 and got["spans"][0]["host_ms"] > 0
    made = {n: fa.launches[n] - before[n] for n in fa.launches if fa.launches[n] > before[n]}
    recs = {}
    for r in got["launches"]:
        recs[r["name"]] = recs.get(r["name"], 0) + 1
    assert recs == made == {"flash_kernel": 3, "full_attention": 1}
    assert got["launches"][0] == {"name": "flash_kernel", "q": (1, 512, 8, 128),
                                  "k": (1, 512, 2, 128), "causal": True, "q_offset": 0,
                                  "lse": True}
