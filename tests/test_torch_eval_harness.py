"""The port's benchmark harness (eval/harness.py) and the predictor's eval
helpers against the JAX package's, on the CPU: one tiny reference-format
checkpoint (tests/test_builder.write_checkpoint, tdc_tiny) loaded by both
packages in f32 with an f32 compressor (the token-identity setting of the
other parity tests) and a stub tokenizer.

run_benchmark's records and metrics equal JAX's (tolerance 0) on JPEG
frame-directory rows with a bound (PIL only: never skipped) and on GIF
videos (the native decoder: skipped where pkg-config finds no FFmpeg).
The port's grouped run (batch_slots=2) equals its one-at-a-time run; the
mid-group fallback, a missing video, a decoder that cannot load, WAL
resume (a torn line, and a log written by JAX's harness), the EgoSchema
CSV, lvcot, answer_video, the CLI (`main` against JAX's `main` on an
MVBench tree) and the bounded feature-cache uid are each checked.
"""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import builder as jbuilder
from tdc_video_tpu.config import tdc_tiny as jtiny
from tdc_video_tpu.eval import harness as jh
from tdc_video_tpu.eval import runner as jrun
from tdc_video_tpu_torch import builder as tbuilder
from tdc_video_tpu_torch.eval import harness as th
from tdc_video_tpu_torch.eval import runner as trun
from tdc_video_tpu_torch.media import build as media_build
from test_builder import write_checkpoint
from test_torch_e2e import JaxStubTokenizer
from torch_parity import StubTokenizer

HAS_FFMPEG, FFMPEG_MSG = media_build.ffmpeg_libraries()
needs_ffmpeg = pytest.mark.skipif(not HAS_FFMPEG,
                                  reason=f"pkg-config finds no FFmpeg libraries: {FFMPEG_MSG}")
PROMPT = "Question: {q}\nOptions:\n(A) x\n(B) y\nRespond with only the letter."


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The checkpoint, both packages' f32 models, two GIFs and two JPEG
    frame directories (3 fps, 30 frames each)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("harness")
    ckpt = str(root / "ckpt")
    write_checkpoint(ckpt, jtiny(), audio=False)
    _, jm, _, _ = jbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=jnp.float32)
    _, tm, _, _ = tbuilder.load_pretrained_model(ckpt, load_tokenizer=False, dtype=torch.float32,
                                                 device="cpu")
    jcfg = dataclasses.replace(jm.cfg, compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.cfg, compress_dtype=torch.float32)
    vids = []
    for v in range(2):
        vid = str(root / f"v{v}.gif")
        ims = [Image.new("RGB", (64, 48), ((i + v) * 37 % 255, 10 + v * 60, 10)) for i in range(6)]
        ims[0].save(vid, save_all=True, append_images=ims[1:], duration=500, loop=0)
        vids.append(vid)
    rng = np.random.default_rng(0)
    dirs = []
    for d in range(2):
        fd = root / f"frames{d}"
        fd.mkdir()
        for k in range(30):
            px = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
            Image.fromarray(np.kron(px, np.ones((8, 8, 1), np.uint8))).save(
                str(fd / f"{k:05d}.jpg"))
        dirs.append(str(fd))
    return dict(ckpt=ckpt, jm=jm, tm=tm, jcfg=jcfg, tcfg=tcfg, vids=vids, dirs=dirs, root=root)


def jpred(env, **kw):
    return jrun.TDCPredictor(env["jcfg"], env["jm"].params, JaxStubTokenizer(),
                             max_new_tokens=3, text_bucket=128, **kw)


def tpred(env, **kw):
    return trun.TDCPredictor(env["tcfg"], env["tm"].params, StubTokenizer(), max_new_tokens=3,
                             text_bucket=128, device="cpu", **kw)


def frame_samples(env):
    """MVBench's frame-directory shape: 3 + 2 questions on two directories,
    each with a bound (frames 3-12 of 30 at 3 fps: 4 frames at 1 fps)."""
    out = []
    for d, (path, bound) in enumerate(zip(env["dirs"], [(1.0, 4.0), (2.0, 5.0)])):
        for i, q in enumerate(["How many?", "Which first?", "What color?"][: 3 - d]):
            out.append({"task_type": "Episodic Reasoning", "bound": bound, "question": q,
                        "prompt": PROMPT.format(q=q), "answer": "AB"[i % 2],
                        "video_name": f"clip{d}", "video": path, "data_type": "frame",
                        "letters": ["A", "B"]})
    return out


def video_samples(env):
    """MLVU's flat shape over the two GIFs: 3 + 2 questions."""
    out = []
    for v, vid in enumerate(env["vids"]):
        for i, q in enumerate(["How many?", "Which first?", "What color?"][: 3 - v]):
            out.append({"task_type": "count" if i % 2 == 0 else "order", "video": vid,
                        "video_name": os.path.basename(vid), "question": q,
                        "prompt": PROMPT.format(q=q), "answer": "AB"[i % 2],
                        "letters": ["A", "B"]})
    return out


def records(out_dir, name="mlvu"):
    (path,) = glob.glob(os.path.join(out_dir, name.upper(), "outputs-*.json"))
    with open(path) as fh:
        return json.load(fh)


def run_port(env, samples, sub, name="mlvu", pred=None, **kw):
    pred = pred or tpred(env)
    out = str(env["root"] / sub)
    metrics = th.run_benchmark(name, pred, samples, out_dir=out, **kw)
    return pred, metrics, records(out, name)


@pytest.fixture(scope="module")
def jax_runs(env):
    """JAX's harness, one question at a time, once on each sample set (one
    predictor: its compiled programs are reused)."""
    pred = jpred(env)
    out = {}
    sets = [("frames", frame_samples(env))] + ([("videos", video_samples(env))] if HAS_FFMPEG
                                                else [])
    for kind, samples in sets:
        d = str(env["root"] / f"jax-{kind}")
        metrics = jh.run_benchmark("mlvu", pred, samples, out_dir=d)
        out[kind] = (metrics, records(d))
    return out


@pytest.mark.parametrize("kind", ["frames", pytest.param("videos", marks=needs_ffmpeg)])
def test_run_benchmark_equals_jax(env, jax_runs, kind):
    samples = frame_samples(env) if kind == "frames" else video_samples(env)
    pred, metrics, recs = run_port(env, samples, f"port-{kind}")
    jm, jrecs = jax_runs[kind]
    assert recs == jrecs and metrics == jm
    assert len(recs) == 5 and "Acc" in metrics
    assert pred.stats.samples == 5


def test_grouped_equals_one_at_a_time(env, monkeypatch):
    """batch_slots=2: every group's questions through answer_many, records
    and metrics equal to the one-at-a-time run; answer() never called and
    each video encoded once."""
    samples = frame_samples(env) + (video_samples(env) if HAS_FFMPEG else [])
    _, m_solo, r_solo = run_port(env, samples, "solo")
    encodes = []
    real = trun.encode_frames
    monkeypatch.setattr(trun, "encode_frames", lambda *a, **k: encodes.append(1) or real(*a, **k))
    pred, m_bat, r_bat = run_port(env, samples, "grouped", batch_slots=2)
    assert r_bat == r_solo and m_bat == m_solo
    assert pred.stats.samples == 0 and len(pred._engine_cache) >= 1
    assert len(encodes) == (4 if HAS_FFMPEG else 2)


def test_mid_group_failure_falls_back(env, monkeypatch):
    samples = frame_samples(env)
    _, _, r_solo = run_port(env, samples, "fb-solo")
    pred = tpred(env)
    real, calls = pred.answer_many, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected mid-group failure")
        return real(*a, **kw)

    monkeypatch.setattr(pred, "answer_many", flaky)
    with pytest.warns(RuntimeWarning, match="answer_many failed"):
        _, _, recs = run_port(env, samples, "fb", pred=pred, batch_slots=2)
    assert recs == r_solo and len(calls) == 2
    assert not os.path.exists(str(env["root"] / "fb" / "MLVU" / "wal-host0.jsonl"))


def test_missing_video_skips_its_group_only(env):
    samples = frame_samples(env)
    for s in samples[:3]:
        s.update(video=str(env["root"] / "gone.mp4"), data_type=None)
    _, _, recs = run_port(env, samples, "skip", batch_slots=2)
    assert {r["video_name"] for r in recs} == {"clip1"} and len(recs) == 2
    samples[3]["video"] = samples[4]["video"] = str(env["root"] / "no-such-dir")
    _, metrics, recs = run_port(env, samples, "skip-all")
    assert recs == [] and metrics == {}


def test_decoder_failure_is_not_a_skipped_row(env, monkeypatch, tmp_path):
    """A decoder that cannot be built or loaded raises out of the harness:
    read as an unreadable video, it would give accuracy over nothing."""
    from tdc_video_tpu_torch.media import io as tio

    def broken():
        raise OSError("libavformat.so: cannot open shared object file")

    monkeypatch.setattr(tio, "_load", broken)
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"not a video")
    samples = [dict(video_samples(env)[0], video=str(clip))]
    with pytest.raises(OSError, match="libavformat"):
        th.run_benchmark("mlvu", tpred(env), samples, out_dir=str(tmp_path / "res"))
    with pytest.raises(OSError, match="libavformat"):
        tpred(env).answer_video(str(clip), "What happens?")


def test_wal_resume(env, jax_runs):
    """A finished run removes its log; a log with one answered question
    and a torn last line resumes past that question; a log written by JAX's
    harness before a crash resumes in the port's, and the records come out
    as JAX's full run."""
    samples = frame_samples(env)
    out = str(env["root"] / "resume")
    pred, m1, r1 = run_port(env, samples, "resume")
    wal = os.path.join(out, "MLVU", "wal-host0.jsonl")
    assert not os.path.exists(wal)
    with open(wal, "w") as fh:
        fh.write(json.dumps(r1[0]) + "\n" + '{"video_name": "clip0", "quest')
    for f in glob.glob(os.path.join(out, "MLVU", "*.json")):
        os.remove(f)
    n = pred.stats.samples
    m2 = th.run_benchmark("mlvu", pred, samples, out_dir=out)
    assert pred.stats.samples == n + 4 and m2 == m1 and records(out) == r1

    # JAX's harness crashes after its second answer; the port resumes its log
    jout = str(env["root"] / "resume-jax")
    jp = jpred(env)
    real, answered = jp.answer, []

    def crash_after_two(*a, **kw):
        if len(answered) == 2:
            raise KeyboardInterrupt("crash")
        answered.append(1)
        return real(*a, **kw)

    jp.answer = crash_after_two
    with pytest.raises(KeyboardInterrupt):
        jh.run_benchmark("mlvu", jp, samples, out_dir=jout)
    with open(os.path.join(jout, "MLVU", "wal-host0.jsonl")) as fh:
        assert len(fh.readlines()) == 2
    pred = tpred(env)
    metrics = th.run_benchmark("mlvu", pred, samples, out_dir=jout)
    assert pred.stats.samples == 3
    jm, jrecs = jax_runs["frames"]
    assert records(jout) == jrecs and metrics == jm


def test_egoschema_csv(env):
    samples = frame_samples(env)
    for i, s in enumerate(samples):
        s.update(task_type="egoschema", question_uid=f"uid{i}", answer="")
    _, _, recs = run_port(env, samples, "ego", name="egoschema")
    with open(str(env["root"] / "ego" / "EGOSCHEMA" / "submission.csv")) as fh:
        rows = [line.strip().split(",") for line in fh]
    assert rows[0] == ["q_uid", "answer"]
    assert rows[1:] == [[r["question_uid"], str(["A", "B"].index(r["pred"]))] for r in recs]
    assert len(rows) == 6


def test_lvcot_equals_jax(env):
    frames = th.load_frame_dir(env["dirs"][0])  # 10 frames at 1 fps
    j = jrun.lvcot(jpred(env), frames, max_forward=2, video_uid="v")
    t = trun.lvcot(tpred(env), frames, max_forward=2, video_uid="v")
    assert t == j and len(t.split()) > 2


@needs_ffmpeg
def test_answer_video_equals_jax(env, tmp_path):
    q = "What happens?"
    assert tpred(env).answer_video(env["vids"][0], q) == jpred(env).answer_video(env["vids"][0], q)
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"\x00" * 4096)
    assert tpred(env).answer_video(str(bad), q) is None
    assert tpred(env).answer_video(str(tmp_path / "missing.mp4"), q) is None


def _mvbench_tree(env, root):
    """An MVBench tree with the episodic-reasoning task only: two bounded
    rows on each frame directory."""
    rows = [{"video": os.path.basename(d), "question": q, "candidates": ["x", "y", "z", "w"],
             "answer": a, "start": 1, "end": 6}
            for d in env["dirs"] for q, a in (("Why?", "y"), ("When?", "w"))]
    os.makedirs(os.path.join(root, "json"))
    with open(os.path.join(root, "json", "episodic_reasoning.json"), "w") as fh:
        json.dump(rows, fh)
    vdir = os.path.join(root, "video", "tvqa", "frames_fps3_hq")
    os.makedirs(vdir)
    for d in env["dirs"]:
        os.symlink(d, os.path.join(vdir, os.path.basename(d)))
    return root


def test_main_prints_jax_metrics(env, monkeypatch, capsys):
    from test_torch_serve import _f32_loaders

    data = _mvbench_tree(env, str(env["root"] / "MVBench"))
    asked = _f32_loaders(monkeypatch)
    argv = ["mvbench", "--model_path", env["ckpt"], "--data_path", data, "--bert_tokenizer", "",
            "--max_new_tokens", "3"]
    jh.main(argv + ["--out_dir", str(env["root"] / "cli-jax")])
    ref = capsys.readouterr().out
    out = th.main(argv + ["--out_dir", str(env["root"] / "cli-port"), "--device", "cpu",
                          "--batch_slots", "2"])
    printed = capsys.readouterr().out
    metric_lines = [[ln for ln in text.splitlines() if ln.startswith("[mvbench] {")]
                    for text in (ref, printed)]
    assert metric_lines[0] == metric_lines[1] and len(metric_lines[0]) == 1
    assert records(str(env["root"] / "cli-port"), "mvbench") == \
        records(str(env["root"] / "cli-jax"), "mvbench")
    assert asked == [("jax", jnp.bfloat16), ("torch", torch.bfloat16)]
    assert set(out["metrics"]) == {"Episodic Reasoning", "Acc"} and out["seconds"] > 0


def test_bounded_groups_answer_from_their_own_frames(env, monkeypatch):
    """Two neighbouring groups of one video with bounds of equal length
    (MVBench's bounded tasks): the port encodes each span and answers each
    group as with no feature cache.  JAX keys its cache on the video's name
    alone, so its second group reuses the first group's features: one
    encode for both."""
    rows = [dict(s, video=env["dirs"][0], video_name="clip", bound=b, question=q,
                 prompt=PROMPT.format(q=q))
            for s in frame_samples(env)[:1] for b, q in (((1.0, 4.0), "A?"), ((5.0, 8.0), "B?"))]
    spans = [th.load_frame_dir(env["dirs"][0], b) for b in ((1.0, 4.0), (5.0, 8.0))]
    assert spans[0].shape == spans[1].shape and not np.array_equal(*spans)

    encodes = []
    real = trun.encode_frames
    monkeypatch.setattr(trun, "encode_frames", lambda *a, **k: encodes.append(1) or real(*a, **k))
    _, _, recs = run_port(env, rows, "bounded")
    assert len(encodes) == 2
    fresh = tpred(env)
    for rec, row, frames in zip(recs, rows, spans):
        want = fresh.answer(frames, row["prompt"], qformer_prompt=row["question"],
                            frame_seconds=np.arange(len(frames), dtype=np.float64))
        assert rec["raw"] == want
    ff = [fresh.encode_video(f)[0] for f in spans]
    assert not torch.equal(*ff)  # the spans' features differ: the check has teeth

    jp = jpred(env)
    jcalls = []
    real_j = jp._encode_fn
    jp._encode_fn = lambda T: jcalls.append(T) or real_j(T)
    jh.run_benchmark("mlvu", jp, rows, out_dir=str(env["root"] / "bounded-jax"))
    assert len(jcalls) == 1  # JAX's stale reuse, recorded in ROADMAP's watch items


def test_shard_and_gather_are_one_process(monkeypatch):
    """One process: every sample, its own records.  Under a group of two
    ranks (stubbed here: no group is made in the pytest process; the real
    two-rank run is tests/test_torch_parallel_eval.py): the round-robin
    share, and the gathered records in rank order through all_gather_object
    of each rank's JSON."""
    import json

    import torch.distributed as dist

    xs = [{"a": 1}, {"b": 2}, {"c": 3}]
    assert trun.shard_samples(xs) == xs and trun.allgather_records(xs) is xs
    assert trun.process_rank() == 0
    other = [{"z": [1, 2]}]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 1)

    def all_gather_object(out, obj):
        out[:] = [json.dumps(other), obj]

    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    assert trun.process_rank() == 1
    assert trun.shard_samples(xs) == [{"b": 2}]
    assert trun.allgather_records(xs) == other + xs
