"""Benchmark dataset adapters (port of tdc_video_tpu/eval/datasets.py; the
JAX package imports jax at its root, so this plain-Python module keeps its
own copy).

Each loader returns a list of dict samples with the reference's fields
(task_type / video / prompt / answer / letters / audio...), mirroring the
EvalDataset of the corresponding reference harness (file:line cited per
loader).  Pure host-side Python; pyarrow (Video-MME's parquet) is imported
inside its loader.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional


def _letters(n: int) -> List[str]:
    return [chr(ord("A") + i) for i in range(n)]


def qa_template_mlvu(data: dict):
    """eval_mlvu.py:101-117."""
    q = f"Question: {data['question']}\nOptions:\n"
    answer = data["answer"]
    idx = -1
    for i, c in enumerate(data["candidates"]):
        q += f"({chr(ord('A') + i)}) {c}\n"
        if c == answer:
            idx = i
    q += "Respond with only the letter (A, B, C or D) of the correct option.\n"
    return q.rstrip(), chr(ord("A") + idx)


MLVU_TASKS = {
    "count": ("json/4_count.json", "video/4_count"),
    "ego": ("json/3_ego.json", "video/3_ego"),
    "needle": ("json/2_needle.json", "video/2_needle"),
    "order": ("json/5_order.json", "video/5_order"),
    "plotQA": ("json/1_plotQA.json", "video/1_plotQA"),
    "anomaly_reco": ("json/6_anomaly_reco.json", "video/6_anomaly_reco"),
    "topic_reasoning": ("json/7_topic_reasoning.json", "video/7_topic_reasoning"),
}


def load_mlvu(data_path: str) -> List[dict]:
    """eval_mlvu.py:48-96: 7 task JSONs."""
    out = []
    for task, (jf, vdir) in MLVU_TASKS.items():
        with open(os.path.join(data_path, jf)) as fh:
            rows = json.load(fh)
        for r in rows:
            prompt, ans = qa_template_mlvu(r)
            out.append(
                {
                    "task_type": task,
                    "video": os.path.join(data_path, vdir, r["video"]),
                    "video_name": r["video"],
                    "question": r["question"],
                    "prompt": prompt,
                    "answer": ans,
                    "letters": _letters(len(r["candidates"])),
                }
            )
    return out


def parse_srt(path: str) -> List[dict]:
    """Minimal SRT reader (replaces pysubs2, eval_videomme.py:214)."""
    subs = []
    with open(path, encoding="utf-8", errors="ignore") as fh:
        blocks = re.split(r"\n\s*\n", fh.read())
    ts = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*(\d+):(\d+):(\d+)[,.](\d+)")
    for b in blocks:
        m = ts.search(b)
        if not m:
            continue
        g = [int(x) for x in m.groups()]
        start = (g[0] * 3600 + g[1] * 60 + g[2]) * 1000 + g[3]
        end = (g[4] * 3600 + g[5] * 60 + g[6]) * 1000 + g[7]
        text = b[m.end() :].strip().replace("\\N", " ").replace("\n", " ")
        subs.append({"start": start, "end": end, "text": text})
    return subs


def subtitles_for_frames(subs: List[dict], frame_seconds, cap: int = 200) -> str:
    """Per-sampled-frame subtitle selection + dedup (eval_videomme.py:215-240)."""
    lines: List[str] = []
    for t in frame_seconds:
        ms = float(t) * 1000
        text = ""
        for s in subs:
            if s["start"] < ms < s["end"]:
                text = s["text"]
                break
        if text.strip() and "[Music]" not in text and "[Applause]" not in text:
            if not lines or (text not in lines and text not in lines[-1]):
                lines.append(text)
    if len(lines) > cap:
        step = len(lines) // cap
        lines = lines[::step]
    if not lines:
        return ""
    return "This video's subtitles are listed below:\n" + "\n".join(lines) + "\n"


def load_videomme(data_path: str) -> List[dict]:
    """eval_videomme.py:100-150: parquet of per-video question groups."""
    from pyarrow import parquet as pq

    table = pq.read_table(
        os.path.join(data_path, "videomme", "test-00000-of-00001.parquet")
    )
    rows = table.to_pylist()
    # group by video (the parquet is one row per question)
    groups: Dict[str, dict] = {}
    for item in rows:
        ytid = item.get("url", item.get("videoID", "")).split("watch?v=")[-1]
        g = groups.setdefault(
            ytid,
            {
                "video_name": ytid,
                "video": os.path.join(data_path, "data", f"{ytid}.mp4"),
                "subtitle": os.path.join(data_path, "subtitle", f"{ytid}.srt"),
                "duration": item.get("duration", ""),
                "questions": [],
            },
        )
        if "questions" in item and isinstance(item["questions"], list):
            g["questions"].extend(item["questions"])
        else:
            g["questions"].append(
                {
                    "question_id": item.get("question_id"),
                    "question": item["question"],
                    "choices": item.get("options", item.get("choices")),
                    "answer": item.get("answer"),
                }
            )
    out = list(groups.values())
    for g in out:
        for fmt in (".mp4", ".avi", ".mov", ".mkv"):
            p = os.path.join(data_path, "data", g["video_name"] + fmt)
            if os.path.exists(p):
                g["video"] = p
                break
    return out


MVBENCH_TASKS = {
    "Action Sequence": ("action_sequence.json", "star/Charades_v1_480/", "video", True),
    "Action Prediction": ("action_prediction.json", "star/Charades_v1_480/", "video", True),
    "Action Antonym": ("action_antonym.json", "ssv2_video/", "video", False),
    "Fine-grained Action": ("fine_grained_action.json", "Moments_in_Time_Raw/videos/", "video", False),
    "Unexpected Action": ("unexpected_action.json", "FunQA_test/test/", "video", False),
    "Object Existence": ("object_existence.json", "clevrer/video_validation/", "video", False),
    "Object Interaction": ("object_interaction.json", "star/Charades_v1_480/", "video", True),
    "Object Shuffle": ("object_shuffle.json", "perception/videos/", "video", False),
    "Moving Direction": ("moving_direction.json", "clevrer/video_validation/", "video", False),
    "Action Localization": ("action_localization.json", "sta/sta_video/", "video", True),
    "Scene Transition": ("scene_transition.json", "scene_qa/video/", "video", False),
    "Action Count": ("action_count.json", "perception/videos/", "video", False),
    "Moving Count": ("moving_count.json", "clevrer/video_validation/", "video", False),
    "Moving Attribute": ("moving_attribute.json", "clevrer/video_validation/", "video", False),
    "State Change": ("state_change.json", "perception/videos/", "video", False),
    "Fine-grained Pose": ("fine_grained_pose.json", "nturgbd/", "video", False),
    "Character Order": ("character_order.json", "perception/videos/", "video", False),
    "Egocentric Navigation": ("egocentric_navigation.json", "vlnqa/", "video", False),
    "Episodic Reasoning": ("episodic_reasoning.json", "tvqa/frames_fps3_hq/", "frame", True),
    "Counterfactual Inference": ("counterfactual_inference.json", "clevrer/video_validation/", "video", False),
}


def load_mvbench(data_path: str) -> List[dict]:
    """eval_mvbench.py:45-160: 20 sub-tasks, incl. a frame-dir task."""
    out = []
    for task, (jf, vdir, dtype, has_bound) in MVBENCH_TASKS.items():
        jp = os.path.join(data_path, "json", jf)
        if not os.path.exists(jp):
            continue
        with open(jp) as fh:
            rows = json.load(fh)
        for r in rows:
            options = r["candidates"]
            letters = _letters(len(options))
            opt_str = "".join(
                f"({letters[i]}) {c}\n" for i, c in enumerate(options)
            )
            idx = options.index(r["answer"]) if r["answer"] in options else -1
            prompt = (
                f"Question: {r['question']}\nOptions:\n{opt_str}"
                "Answer with the option's letter from the given choices directly "
                "and only give the best option."
            )
            out.append(
                {
                    "task_type": task,
                    "bound": (r.get("start"), r.get("end")) if has_bound else None,
                    "question": r["question"],
                    "prompt": prompt,
                    "answer": letters[idx] if idx >= 0 else "A",
                    "video_name": r["video"].split(".")[0],
                    "video": os.path.join(data_path, "video", vdir, r["video"]),
                    "data_type": dtype,
                    "letters": letters,
                }
            )
    return out


def load_egoschema(data_path: str) -> List[dict]:
    """eval_egoschema.py:49-74 + Kaggle CSV output (eval/README.md:27)."""
    with open(os.path.join(data_path, "questions.json")) as fh:
        rows = json.load(fh)
    out = []
    for r in rows:
        options = [r[f"option {i}"] for i in range(5) if f"option {i}" in r]
        letters = _letters(len(options))
        opt_str = "".join(f"({letters[i]}) {c}\n" for i, c in enumerate(options))
        prompt = (
            f"Question: {r['question']}\nOptions:\n{opt_str}"
            "Respond with only the letter of the correct option.\n"
        ).rstrip()
        out.append(
            {
                "task_type": "egoschema",
                "question_uid": r["q_uid"],
                "video": os.path.join(data_path, "videos", f"{r['q_uid']}.mp4"),
                "video_name": r["q_uid"],
                "question": r["question"],
                "prompt": prompt,
                "answer": "",  # hidden test set; scored on Kaggle
                "letters": letters,
            }
        )
    return out


def load_perception(data_path: str) -> List[dict]:
    """eval_perception.py:49-85 (mc_question_valid.json keyed by video)."""
    with open(os.path.join(data_path, "mc_question_valid.json")) as fh:
        data = json.load(fh)
    out = []
    for vid, entry in data.items():
        for q in entry["mc_question"]:
            options = q["options"]
            letters = _letters(len(options))
            opt_str = "".join(f"({letters[i]}) {c}\n" for i, c in enumerate(options))
            prompt = (
                f"Question: {q['question']}\nOptions:\n{opt_str}"
                "Respond with only the letter of the correct option.\n"
            ).rstrip()
            out.append(
                {
                    "task_type": q.get("area", "perception"),
                    "qid": q["id"],
                    "video": os.path.join(data_path, "videos", f"{vid}.mp4"),
                    "video_name": vid,
                    "question": q["question"],
                    "prompt": prompt,
                    "answer": letters[q["answer_id"]],
                    "letters": letters,
                }
            )
    return out


def fill_musicqa_template(line: dict) -> str:
    """eval_musicQA.py:70-81: substitute <X> template slots."""
    question = line["question_content"]
    matches = re.findall(r"<(.*?)>", question)
    values = ast.literal_eval(line["templ_values"])
    for pat, val in zip(matches, values):
        question = question.replace(f"<{pat}>", val, 1)
    return question


def load_musicqa(data_path: str) -> List[dict]:
    """eval_musicQA.py:44-110: audio-visual QA, free-form answers."""
    with open(os.path.join(data_path, "avqa-test.json")) as fh:
        rows = json.load(fh)
    out = []
    for r in rows:
        q = fill_musicqa_template(r)
        out.append(
            {
                "task_type": r.get("type", "musicqa"),
                "video": os.path.join(data_path, "videos", f"{r['video_id']}.mp4"),
                "audio": os.path.join(data_path, "audios", f"{r['video_id']}.wav"),
                "video_name": r["video_id"],
                "question": q,
                "prompt": q + " Answer with a single word or phrase.",
                "answer": str(r.get("anser", r.get("answer", ""))).strip(),
                "free_form": True,
            }
        )
    return out


def load_avsd(data_path: str) -> List[dict]:
    """eval_avsd.py:49-80: dialog QA over audio-visual scenes."""
    with open(data_path) as fh:
        data = json.load(fh)
    out = []
    for vid, entry in data.items():
        dialogs = entry.get("data", entry.get("dialog", []))
        for turn in dialogs:
            out.append(
                {
                    "task_type": "avsd",
                    "video": entry.get("video", vid),
                    "audio": entry.get("audio"),
                    "video_name": vid,
                    "question": turn["question"],
                    "prompt": turn["question"] + " Answer briefly.",
                    "answer": turn.get("answer", ""),
                    "free_form": True,
                }
            )
    return out


def _norm_question(line: dict, q: dict) -> dict:
    """Normalize one question of a grouped sample into the flat per-question
    schema (prompt/answer/letters/task_type).  Video-MME loader questions
    carry raw `choices` and inherit their task_type from the group's duration
    bucket (eval_videomme.py:241-260); flat-style dicts pass through."""
    if "prompt" in q:
        return q
    opt = "".join(f"{o}\n" for o in q.get("choices") or [])
    prompt = (
        f"Question: {q['question']}\nOptions:\n{opt}"
        "Respond with only the letter (A, B, C, or D) of the correct option.\n"
    ).rstrip()
    return {
        "question": q["question"],
        "prompt": prompt,
        "answer": q.get("answer", ""),
        "task_type": line.get("duration", "videomme"),
    }


def group_by_video(samples: List[dict]) -> List[dict]:
    """Group flat per-question samples sharing one video (and bound / frame-dir
    / audio identity) so the harness decodes + encodes each video ONCE and can
    route all of its questions through one continuous-batching engine call
    (runner.answer_many shared-prefix admission).

    The reference harnesses re-read and re-encode the video per question
    (eval_mlvu.py:151-238 loops one row at a time); grouping is the
    throughput upgrade the engine already measured (PERF.md shared-prefix
    rows).  Samples that already carry a `questions` list (Video-MME parquet
    groups) pass through with their questions normalized.  Per-question
    record/WAL semantics are unchanged: each question keeps its own flat
    dict inside the group's `questions`."""
    groups: Dict[tuple, dict] = {}
    order: List[dict] = []
    for s in samples:
        if "questions" in s:
            g = dict(s)
            g["questions"] = [_norm_question(s, q) for q in s["questions"]]
            order.append(g)
            continue
        key = (
            s["video"],
            s.get("data_type"),
            tuple(s["bound"]) if s.get("bound") else None,
            s.get("audio"),
            s.get("subtitle"),
        )
        g = groups.get(key)
        if g is None:
            g = {
                k: s[k]
                for k in ("video", "video_name", "data_type", "bound", "audio", "subtitle")
                if k in s
            }
            g["questions"] = []
            groups[key] = g
            order.append(g)
        g["questions"].append(s)
    return order


LOADERS = {
    "mlvu": load_mlvu,
    "videomme": load_videomme,
    "mvbench": load_mvbench,
    "egoschema": load_egoschema,
    "perception": load_perception,
    "musicqa": load_musicqa,
    "avsd": load_avsd,
}
