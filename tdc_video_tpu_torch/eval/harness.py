"""Benchmark harness (port of tdc_video_tpu/eval/harness.py): load model ->
shard -> predict -> aggregate -> dump.

One runner covers all seven reference harnesses (eval/eval_*.py); their
differences (subtitles, audio, frame-directory videos, the Kaggle CSV,
free-form answers) come from the sample dicts.

    python -m tdc_video_tpu_torch.eval.harness mlvu \\
        --model_path checkpoints/TDC-Qwen2-7B --data_path /data/MLVU

Runs on CUDA unless --device cpu.  `run(args, tokenizer=...)` takes any
tokenizer with encode/decode in place of the checkpoint's transformers
tokenizer.  There is no compile cache to enable, as the JAX CLI enables
XLA's: eager PyTorch compiles nothing, and the CUDA kernels are built once
per checkout.

Under torchrun (WORLD_SIZE > 1) the run is data-parallel over the ranks, as
JAX's over hosts: each rank joins the process group, builds its own
predictor on cuda:LOCAL_RANK (or --device), answers its round-robin share
of the video groups (runner.shard_samples) with its own log
(wal-host<rank>.jsonl), and rank 0 writes the gathered records:

    torchrun --nproc_per_node 8 -m tdc_video_tpu_torch.eval.harness mlvu ...

One divergence from JAX: a group whose sample has a bound (MVBench's
bounded tasks) caches its features under the video's name and the bound,
where JAX uses the name alone (its harness.py:178), so that two
neighbouring groups of one video with bounds of equal length are not
answered from one set of features.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np

from ..media import io as media_io
from .datasets import LOADERS, group_by_video, parse_srt, subtitles_for_frames
from .runner import (
    TDCPredictor,
    accuracy_by_task,
    allgather_records,
    dump_results,
    extract_letter,
    lvcot,
    process_rank,
    shard_samples,
)


def load_frame_dir(path: str, bound=None, sample_fps: float = 1.0) -> np.ndarray:
    """MVBench's episodic-reasoning videos ship as directories of 3-fps JPEG
    frames (eval_mvbench.py tvqa/frames_fps3_hq)."""
    from PIL import Image

    files = sorted(glob.glob(os.path.join(path, "*.jpg")))
    if bound and bound[0] is not None:
        fps = 3.0
        lo, hi = int(bound[0] * fps), int(bound[1] * fps) + 1
        files = files[lo:hi]
    files = files[:: max(1, int(3 / sample_fps))]
    return np.stack([np.asarray(Image.open(f).convert("RGB")) for f in files])


def _build_record(line: dict, q: dict, pred: str) -> dict:
    """One question's result record, the same on the grouped and the
    one-at-a-time paths."""
    letters = q.get("letters", ["A", "B", "C", "D"])
    rec = {
        "video_name": line["video_name"],
        "question": q["question"],
        "answer": q.get("answer", ""),
        "task_type": q.get("task_type", "all"),
        "raw": pred,
    }
    if q.get("free_form", False):
        rec["pred"] = pred.strip().rstrip(".").lower()
        rec["answer"] = str(q.get("answer", "")).lower()
    else:
        rec["pred"] = extract_letter(pred, letters)
    if "question_uid" in q:
        rec["question_uid"] = q["question_uid"]
        rec["pred_idx"] = letters.index(rec["pred"])
    return rec


def video_uid(line: dict) -> str:
    """The feature-cache uid of a group: the video's name, with its bound
    when it has one (module docstring)."""
    bound = line.get("bound")
    if bound and bound[0] is not None:
        return f"{line['video_name']}@{bound[0]}-{bound[1]}"
    return line["video_name"]


def _group_frames(predictor: TDCPredictor, line: dict):
    """A group's frames and their seconds, or None when its video is
    missing or unreadable.  A decoder that cannot be built raises."""
    if line.get("data_type") == "frame":
        if not os.path.isdir(line["video"]):
            return None
        frames = load_frame_dir(line["video"], line.get("bound"))
        return frames, np.arange(len(frames), dtype=np.float64)
    if not os.path.exists(line["video"]):
        return None
    media_io.decoder()
    try:
        frames, frame_seconds = media_io.decode_video(
            line["video"], fps=predictor.cfg.video_fps, max_frames=predictor.max_eval_frames)
    except OSError:
        return None
    bound = line.get("bound")
    if bound and bound[0] is not None:
        # MVBench's bounded tasks: only the [start, end] span
        keep = (frame_seconds >= bound[0]) & (frame_seconds <= bound[1])
        if keep.any():
            frames, frame_seconds = frames[keep], frame_seconds[keep]
    return frames, frame_seconds


def _answer_group(name, predictor, line, pend, frames, frame_seconds, use_lvcot, batch_slots,
                  emit):
    """Answer one group's pending questions, emit(line, question, answer)
    each: through answer_many with batch_slots > 1 (one at a time if that
    fails), else one at a time, each emitted as it comes (a crash loses at
    most the answer in flight)."""
    uid = video_uid(line)
    # the group's prompt prefix: subtitles (eval_videomme.py:204-240) and
    # LVCoT (eval_mlvu.py:189-194), once a video
    prefix = ""
    sub_path = line.get("subtitle")
    if sub_path and os.path.exists(sub_path):
        prefix = subtitles_for_frames(parse_srt(sub_path), frame_seconds)
    if use_lvcot and len(frames) >= 600:
        prefix = f"<think>{lvcot(predictor, frames, max_forward=2, video_uid=uid)}</think>" + prefix
    prefix += line.get("prompt", "")  # a group-level prompt (rare)
    wav = None
    if line.get("audio") and os.path.exists(line["audio"]):
        wav = media_io.load_audio(line["audio"])

    kw = dict(wav=wav, frame_seconds=frame_seconds, video_uid=uid)
    if batch_slots > 1 and len(pend) > 1:
        try:
            preds = predictor.answer_many(
                frames, [(prefix + q["prompt"], q["question"]) for q in pend],
                num_slots=batch_slots, **kw)
        except Exception as e:
            # a failure inside the engine must not strand the video's
            # questions (the engine resets at its next answer_many)
            warnings.warn(f"[{name}] answer_many failed for {line['video_name']!r} ({e!r}); "
                          "falling back to per-question decoding", RuntimeWarning)
        else:
            for q, pred in zip(pend, preds):
                emit(line, q, pred)
            return
    for q in pend:
        emit(line, q, predictor.answer(frames, prefix + q["prompt"], qformer_prompt=q["question"],
                                       **kw))


def run_benchmark(
    name: str,
    predictor: TDCPredictor,
    samples: List[dict],
    out_dir: str = "./results",
    use_lvcot: bool = False,
    limit: Optional[int] = None,
    resume: bool = True,
    batch_slots: int = 0,
) -> dict:
    """Answer every question, one video group at a time, and write the
    records and per-task accuracy under out_dir/<NAME>/; returns the
    metrics.  Each group's video is decoded and encoded once; with
    batch_slots > 1 its questions decode together through answer_many
    (falling back to one at a time, with a RuntimeWarning, if that fails).
    `limit` counts videos.  Every record is appended to a write-ahead log
    as it is produced; a rerun skips the (video_name, question) pairs the
    log holds, and a finished run removes it."""
    samples = shard_samples(group_by_video(samples))
    if limit:
        samples = samples[:limit]

    os.makedirs(os.path.join(out_dir, name.upper()), exist_ok=True)
    wal_path = os.path.join(out_dir, name.upper(), f"wal-host{process_rank()}.jsonl")
    records: List[dict] = []
    done = set()
    if resume and os.path.exists(wal_path):
        with open(wal_path) as fh:
            for line in fh:
                try:
                    r = json.loads(line)
                except ValueError:
                    continue  # a torn write from a crash
                records.append(r)
                done.add((r.get("video_name"), r.get("question")))
        if records:
            print(f"[{name}] resuming past {len(records)} answered samples", flush=True)
    with open(wal_path, "a") as wal:

        def emit(line, q, pred):
            rec = _build_record(line, q, pred)
            records.append(rec)
            wal.write(json.dumps(rec) + "\n")
            wal.flush()

        t_start = time.time()
        for i, line in enumerate(samples):
            pend = [q for q in line["questions"] if (line["video_name"], q["question"]) not in done]
            if not pend:
                continue  # the whole video was answered before a crash
            got = _group_frames(predictor, line)
            if got is None or len(got[0]) == 0:
                continue
            _answer_group(name, predictor, line, pend, *got, use_lvcot, batch_slots, emit)
            if i % 10 == 0:
                print(f"[{name}] {i + 1}/{len(samples)} ({time.time() - t_start:.0f}s)", flush=True)

    records = allgather_records(records)
    metrics = accuracy_by_task(records)
    dump_results(records, metrics, os.path.join(out_dir, name.upper()), name)
    # outputs-*.json now holds every record: a stale log would seed a later
    # run of the same out_dir with old answers
    try:
        os.remove(wal_path)
    except OSError:
        pass

    if name == "egoschema" and process_rank() == 0:  # the Kaggle CSV (eval/README.md:27)
        path = os.path.join(out_dir, "EGOSCHEMA", "submission.csv")
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["q_uid", "answer"])
            for r in records:
                w.writerow([r["question_uid"], r["pred_idx"]])
        print(f"[egoschema] kaggle csv -> {path}", flush=True)
    return metrics


def _calibration_pixels(args, samples: List[dict]):
    """With --quantize int8-all and --calib_frames > 0: the preprocessed
    first --calib_frames frames of the benchmark's first readable video,
    for static tower activation scales; None otherwise."""
    if getattr(args, "quantize", None) != "int8-all" or getattr(args, "calib_frames", 0) <= 0:
        return None
    from ..builder import read_config
    from ..data.images import process_frames

    n = args.calib_frames
    for line in samples or ():
        if line.get("data_type") == "frame" or not os.path.exists(line.get("video", "")):
            continue
        media_io.decoder()
        try:
            frames, _ = media_io.decode_video(line["video"], fps=1.0, max_frames=n)
        except OSError:
            continue
        if len(frames) == 0:
            continue
        print(f"[calib] activation scales from {line['video']} ({len(frames[:n])} frames)",
              flush=True)
        return process_frames(list(frames[:n]), read_config(args.model_path))
    return None


def build_predictor(args, samples: Optional[List[dict]] = None, tokenizer=None) -> TDCPredictor:
    """The checkpoint loaded as the CLI loads it (bf16 compute), its
    tokenizer (or `tokenizer`), the BERT tokenizer when --bert_tokenizer
    names one, and a TDCPredictor with the CLI's options."""
    import torch

    from ..builder import load_pretrained_model
    from .runner import HFTokenizerAdapter

    quantize = getattr(args, "quantize", None)
    hf_tok, model, _, _ = load_pretrained_model(
        args.model_path, args.model_base, args.model_name, dtype=torch.bfloat16,
        load_tokenizer=tokenizer is None, quantize=quantize,
        calib_pixels=_calibration_pixels(args, samples), device=args.device)
    bert_tok = None
    if args.bert_tokenizer:
        from transformers import BertTokenizer

        bert_tok = BertTokenizer.from_pretrained(args.bert_tokenizer, truncation_side="right")
    return TDCPredictor(
        model.cfg, model.params, tokenizer if tokenizer is not None else HFTokenizerAdapter(hf_tok),
        bert_tokenizer=bert_tok, max_new_tokens=args.max_new_tokens,
        max_eval_frames=args.max_frames, device_preprocess=args.device_preprocess,
        act_quant=quantize == "int8-all", spec_window=getattr(args, "spec_window", 0),
        device=args.device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="TDC-Video eval harness (PyTorch/CUDA port)")
    ap.add_argument("benchmark", choices=sorted(LOADERS))
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--model_base", default=None)
    ap.add_argument("--model_name", default=None)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--bert_tokenizer", default="./checkpoints/bert-base-uncased")
    ap.add_argument("--out_dir", default="./results")
    ap.add_argument("--use_lvcot", action="store_true")
    ap.add_argument("--max_new_tokens", type=int, default=5)
    ap.add_argument("--max_frames", type=int, default=1000)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--device_preprocess", action="store_true",
                    help="pad, resize and normalize frames on the device (the host path, "
                         "bit for bit the reference's processor chain, is the default)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the run into LOGDIR and print the "
                         "last answer's stages")
    ap.add_argument("--quantize", default=None, choices=["int8", "int8-all"],
                    help="int8: weight-only int8 LM; int8-all: the towers too, with int8 "
                         "products")
    ap.add_argument("--calib_frames", type=int, default=8,
                    help="with --quantize int8-all: calibrate static tower activation scales "
                         "on this many frames of the benchmark's first video; 0 = per-token "
                         "scales")
    ap.add_argument("--batch_slots", type=int, default=0,
                    help="decode a video's questions together through the continuous-batching "
                         "engine with this many slots (answer_many); 0/1 = one at a time")
    ap.add_argument("--spec_window", type=int, default=0,
                    help="prompt-lookup speculative decoding window (greedy: the same tokens)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, tokenizer=None) -> Dict[str, Any]:
    """Load the benchmark and the model, run it; returns the metrics and
    the seconds of the run (the model's load excluded)."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel.mesh import init_distributed

        args = argparse.Namespace(**{**vars(args),
                                     "device": str(init_distributed(device=args.device))})
    samples = LOADERS[args.benchmark](args.data_path)
    predictor = build_predictor(args, samples, tokenizer)
    ctx = contextlib.nullcontext()
    if args.profile:
        from ..utils.profiling import trace

        ctx = trace(args.profile)
    t0 = time.time()
    with ctx:
        metrics = run_benchmark(args.benchmark, predictor, samples, out_dir=args.out_dir,
                                use_lvcot=args.use_lvcot, limit=args.limit,
                                batch_slots=args.batch_slots)
    seconds = time.time() - t0
    if args.profile:
        s = predictor.stats
        print(f"[profile] {s.samples} samples; last answer: encode {s.encode_s:.2f}s "
              f"compress+prefill {s.prefill_s:.2f}s decode {s.decode_s:.2f}s "
              f"({s.decode_steps} steps); trace -> {args.profile}", flush=True)
    return {"metrics": metrics, "seconds": seconds}


def main(argv=None) -> Dict[str, Any]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
