"""The port's benchmark data layer (eval/datasets.py and the pure helpers of
eval/runner.py) against the JAX package's: letter extraction, SRT parsing
and subtitle selection, the MLVU and MusicQA templates, grouping by video,
accuracy by task, and each of the seven loaders on fixtures written under
tmp_path.  Every comparison is exact equality of the returned Python
values."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tdc_video_tpu.eval import datasets as jds
from tdc_video_tpu.eval import runner as jrun
from tdc_video_tpu_torch.eval import datasets as tds
from tdc_video_tpu_torch.eval import runner as trun

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("text,letters", [
    ("(B)", None), ("Answer: C.", None), (" A ", None), ("The answer is [D]", None),
    ("nothing here", None), ("(E)", ("A", "B", "C", "D")), ("(E) maybe", ("A", "B", "C", "D", "E")),
    ("b", ("A", "B")), ("[C]", ("A", "B")),
])
def test_extract_letter_equals_jax(text, letters):
    args = (text,) if letters is None else (text, letters)
    assert trun.extract_letter(*args) == jrun.extract_letter(*args)
    assert trun.LETTERS == jrun.LETTERS


SRT = """1
00:00:00,000 --> 00:00:02,500
hello world

2
00:00:03,000 --> 00:00:05,000
[Music]

3
00:00:05,500 --> 00:00:09,000
second line\\Nwrapped

4
00:00:09.000 --> 00:00:11.000
hello
"""


def test_srt_and_subtitles_equal_jax(tmp_path):
    p = tmp_path / "a.srt"
    p.write_text(SRT)
    subs = tds.parse_srt(str(p))
    assert subs == jds.parse_srt(str(p)) and len(subs) == 4
    for secs in ([1.0, 4.0, 6.0], [0.5, 1.0, 6.0, 7.0, 10.0], [20.0], []):
        assert tds.subtitles_for_frames(subs, secs) == jds.subtitles_for_frames(subs, secs)
    # over the cap: every step-th line is kept
    many = [{"start": 1000 * i, "end": 1000 * i + 900, "text": f"line {i}"} for i in range(50)]
    secs = [i + 0.5 for i in range(50)]
    out = tds.subtitles_for_frames(many, secs, cap=8)
    assert out == jds.subtitles_for_frames(many, secs, cap=8) and "line 49" not in out


def test_templates_equal_jax():
    row = {"question": "What color?", "candidates": ["red", "blue", "green"], "answer": "blue"}
    assert tds.qa_template_mlvu(row) == jds.qa_template_mlvu(row)
    assert tds.qa_template_mlvu(row)[1] == "B"
    line = {"question_content": "Is the <Object> louder than the <Object>?",
            "templ_values": "[\"drum\", \"piano\"]"}
    assert tds.fill_musicqa_template(line) == jds.fill_musicqa_template(line) \
        == "Is the drum louder than the piano?"


def _flat(video, q, bound=None, **kw):
    s = {"task_type": "count", "video": video, "video_name": video, "question": q,
         "prompt": f"Question: {q}\n(A) x\n(B) y", "answer": "A", "letters": ["A", "B"]}
    if bound is not None:
        s["bound"] = bound
    s.update(kw)
    return s


@pytest.mark.parametrize("case", ["share_video", "distinct_bounds", "videomme", "audio_subtitle"])
def test_group_by_video_equals_jax(case):
    if case == "share_video":
        samples = [_flat("a.mp4", "q1"), _flat("b.mp4", "q2"), _flat("a.mp4", "q3")]
    elif case == "distinct_bounds":
        samples = [_flat("a.mp4", "q1", bound=(0, 5)), _flat("a.mp4", "q2", bound=(5, 10)),
                   _flat("a.mp4", "q3", bound=(0, 5)), _flat("a.mp4", "q4", data_type="frame")]
    elif case == "videomme":
        samples = [{"video": "v.mp4", "video_name": "v", "duration": "short",
                    "questions": [{"question": "How many?", "choices": ["A. 1", "B. 2"],
                                   "answer": "A"}, _flat("v.mp4", "flat one")]}]
    else:
        samples = [_flat("a.mp4", "q1", audio="a.wav"), _flat("a.mp4", "q2"),
                   _flat("a.mp4", "q3", audio="a.wav", subtitle="a.srt")]
    out = tds.group_by_video(samples)
    assert out == jds.group_by_video(samples)
    if case == "share_video":
        assert [g["video"] for g in out] == ["a.mp4", "b.mp4"]
        assert out[0]["questions"][0] is samples[0]  # the question dicts pass through
    if case == "distinct_bounds":
        assert [len(g["questions"]) for g in out] == [2, 1, 1]


def test_accuracy_by_task_equals_jax():
    recs = [{"task_type": "count", "pred": "A", "answer": "A"},
            {"task_type": "count", "pred": "B", "answer": "A"},
            {"task_type": "order", "pred": "C", "answer": "C"},
            {"pred": "yes", "answer": "no"}]
    assert trun.accuracy_by_task(recs) == jrun.accuracy_by_task(recs)
    assert trun.accuracy_by_task([]) == jrun.accuracy_by_task([]) == {}


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh)


def _fixture(name, root):
    """One benchmark's files under root; returns the loader's argument."""
    root = str(root)
    if name == "mlvu":
        for i, (jf, _) in enumerate(tds.MLVU_TASKS.values()):
            _write(os.path.join(root, jf), [
                {"video": f"v{i}.mp4", "question": f"Q{i}?", "candidates": ["x", "y", "z"],
                 "answer": ["x", "y", "z"][i % 3]},
                {"video": "w.mp4", "question": "Other?", "candidates": ["p", "q"], "answer": "q"},
            ])
        return root
    if name == "videomme":
        import pyarrow as pa
        import pyarrow.parquet as pq

        rows = [
            {"url": "https://www.youtube.com/watch?v=abc", "videoID": "x", "duration": "short",
             "question_id": "1-1", "question": "How many?", "options": ["A. 1", "B. 2"],
             "answer": "A"},
            {"url": "https://www.youtube.com/watch?v=abc", "videoID": "x", "duration": "short",
             "question_id": "1-2", "question": "What color?", "options": ["A. red", "B. blue"],
             "answer": "B"},
            {"url": "https://www.youtube.com/watch?v=def", "videoID": "y", "duration": "long",
             "question_id": "2-1", "question": "Who?", "options": ["A. me", "B. you"],
             "answer": "B"},
        ]
        os.makedirs(os.path.join(root, "videomme"))
        pq.write_table(pa.Table.from_pylist(rows),
                       os.path.join(root, "videomme", "test-00000-of-00001.parquet"))
        os.makedirs(os.path.join(root, "data"))
        open(os.path.join(root, "data", "def.mkv"), "wb").close()  # found by extension
        return root
    if name == "mvbench":
        for jf, rows in (
            ("action_sequence.json", [
                {"video": "a.mp4", "question": "First?", "candidates": ["sit", "stand"],
                 "answer": "stand", "start": 1.5, "end": 7.0},
                {"video": "b.mp4", "question": "Then?", "candidates": ["x", "y", "z"],
                 "answer": "not an option", "start": 0, "end": 3}]),
            ("object_shuffle.json", [
                {"video": "c.mp4", "question": "Where?", "candidates": ["l", "r"],
                 "answer": "l"}]),
            ("episodic_reasoning.json", [
                {"video": "d_clip", "question": "Why?", "candidates": ["a", "b", "c", "d"],
                 "answer": "c", "start": 2.0, "end": 12.0}]),
        ):
            _write(os.path.join(root, "json", jf), rows)
        return root
    if name == "egoschema":
        _write(os.path.join(root, "questions.json"), [
            {"q_uid": "u1", "question": "What?", **{f"option {i}": f"o{i}" for i in range(5)}},
            {"q_uid": "u2", "question": "Why?", "option 0": "a", "option 1": "b"}])
        return root
    if name == "perception":
        _write(os.path.join(root, "mc_question_valid.json"), {
            "video_1": {"mc_question": [
                {"id": 0, "question": "Count?", "options": ["1", "2", "3"], "answer_id": 2,
                 "area": "counting"},
                {"id": 1, "question": "Shape?", "options": ["a", "b"], "answer_id": 0}]},
            "video_2": {"mc_question": []}})
        return root
    if name == "musicqa":
        _write(os.path.join(root, "avqa-test.json"), [
            {"video_id": "00001", "question_content": "Is the <Object> louder than the <Object>?",
             "templ_values": "[\"drum\", \"piano\"]", "type": "Audio-Visual", "anser": "Yes "},
            {"video_id": "00002", "question_content": "How many instruments?",
             "templ_values": "[]", "answer": 3}])
        return root
    assert name == "avsd"
    path = os.path.join(root, "avsd.json")
    _write(path, {
        "vid1": {"video": "/data/vid1.mp4", "audio": "/data/vid1.wav",
                 "data": [{"question": "Is it raining?", "answer": "no"},
                          {"question": "Who talks?"}]},
        "vid2": {"dialog": [{"question": "What room?", "answer": "kitchen"}]}})
    return path


@pytest.mark.parametrize("name", sorted(jds.LOADERS))
def test_loader_equals_jax(name, tmp_path):
    arg = _fixture(name, tmp_path)
    out = tds.LOADERS[name](arg)
    assert out == jds.LOADERS[name](arg)
    assert out, name
    assert sorted(tds.LOADERS) == sorted(jds.LOADERS)
    if name == "mvbench":
        frame = [s for s in out if s["data_type"] == "frame"]
        assert len(frame) == 1 and frame[0]["bound"] == (2.0, 12.0)
        assert [s["answer"] for s in out if s["task_type"] == "Action Sequence"] == ["B", "A"]
    if name == "videomme":
        assert [len(g["questions"]) for g in out] == [2, 1]
        assert out[1]["video"].endswith("def.mkv")


def test_eval_modules_import_no_optional_libraries():
    """The port's eval, streaming and tool modules import without PIL,
    pyarrow or transformers (each loaded inside the function that needs
    it)."""
    code = textwrap.dedent(
        """
        import sys
        import tdc_video_tpu_torch.eval.datasets, tdc_video_tpu_torch.eval.harness
        import tdc_video_tpu_torch.serving.streaming, tdc_video_tpu_torch.cli.activation_diff
        import tdc_video_tpu_torch.cli.model_ops, tdc_video_tpu_torch.models.projector
        libs = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("PIL", "pyarrow", "transformers", "jax"))
        assert not libs, libs
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
