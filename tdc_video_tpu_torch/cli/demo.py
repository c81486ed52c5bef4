"""Single-shot video QA demo (port of tdc_video_tpu/cli/demo.py): decode at
1 fps, the model's conversation template, greedy decoding.  An audio-visual
checkpoint hears --audio, or else the video's own soundtrack.

    python -m tdc_video_tpu_torch.cli.demo --model_path checkpoints/TDC-Llama3.2-3B \
        --video examples/video1.mp4 --question "Describe this video in detail."

Runs on CUDA unless --device cpu.  The tokenizer is read from the
checkpoint directory with transformers; `run(args, tokenizer=...)` takes
any tokenizer with encode/decode instead.  --quantize int8 makes the LM
weight-only int8 and int8-all also the towers (with s8 x s8 prefill);
--kv_quant int8 an int8 KV cache; --spec_window N (>= 2) prompt-lookup
speculative decoding, token-identical to plain greedy; --profile LOGDIR
writes a torch.profiler trace of the answer into LOGDIR.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="TDC-Video demo (PyTorch/CUDA port)")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--model_base", default=None)
    ap.add_argument("--model_name", default=None)
    ap.add_argument("--video", required=True)
    ap.add_argument("--audio", default=None)
    ap.add_argument("--question", default="Describe this video in detail.")
    ap.add_argument("--bert_tokenizer", default="./checkpoints/bert-base-uncased")
    ap.add_argument("--max_new_tokens", type=int, default=128)
    ap.add_argument("--max_frames", type=int, default=1000)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted as in the JAX demo, which decodes greedily whatever its value")
    ap.add_argument("--kv_quant", default=None, choices=["int8"],
                    help="int8 KV cache (halves the cache's bytes)")
    ap.add_argument("--spec_window", type=int, default=0,
                    help="prompt-lookup speculative decoding window (>= 2 enables; the same "
                         "tokens as plain greedy decoding)")
    ap.add_argument("--quantize", default=None, choices=["int8", "int8-all"],
                    help="int8: weight-only int8 LM; int8-all: also int8 towers and s8 x s8 "
                         "prefill")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the answer into LOGDIR and print "
                         "its stage times")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, tokenizer=None) -> Dict[str, Any]:
    """Load, decode, answer.  `tokenizer` (encode/decode) replaces the
    checkpoint's transformers tokenizer when given.  Returns the answer, its
    token ids, the frame count and the seconds of each step."""
    import torch

    from ..builder import load_pretrained_model
    from ..eval.runner import HFTokenizerAdapter, TDCPredictor
    from ..media.io import decode_video, load_audio
    from ..utils.profiling import trace

    t_load = time.time()
    hf_tok, model, _, _ = load_pretrained_model(
        args.model_path, args.model_base, args.model_name, dtype=torch.bfloat16,
        load_tokenizer=tokenizer is None, quantize=args.quantize, device=args.device)
    tokenizer = tokenizer if tokenizer is not None else HFTokenizerAdapter(hf_tok)
    bert_tok = None
    if args.bert_tokenizer:
        try:
            from transformers import BertTokenizer

            bert_tok = BertTokenizer.from_pretrained(args.bert_tokenizer, truncation_side="right")
        except (ImportError, OSError) as e:  # no package, or no tokenizer files there
            print(f"no BERT tokenizer ({type(e).__name__}): the compression is not text-conditioned")
    load_s = time.time() - t_load
    print(f"model loaded in {load_s:.1f}s")

    t0 = time.time()
    frames, ts = decode_video(args.video, fps=model.cfg.video_fps, max_frames=args.max_frames)
    wav = None
    if args.audio:
        wav = load_audio(args.audio)
    elif model.cfg.audio_input:
        wav = load_audio(args.video)  # the video's own soundtrack
    decode_s = time.time() - t0
    audio = "none" if wav is None else f"{len(wav) / 16000:.1f}s"
    print(f"video: {len(frames)} frames @ {model.cfg.video_fps:g} fps, audio: {audio}, "
          f"decoded in {decode_s:.2f}s")

    predictor = TDCPredictor(model.cfg, model.params, tokenizer, bert_tokenizer=bert_tok,
                             max_new_tokens=args.max_new_tokens, max_eval_frames=args.max_frames,
                             device=args.device, act_quant=args.quantize == "int8-all",
                             kv_quant=args.kv_quant, spec_window=args.spec_window)
    t1 = time.time()
    with trace(args.profile) if args.profile else contextlib.nullcontext():
        answer = predictor.answer(frames, args.question, wav=wav, frame_seconds=ts,
                                  max_new_tokens=args.max_new_tokens, video_uid=args.video)
    answer_s = time.time() - t1
    print(f"\n{answer}\n\n[{answer_s:.1f}s inference]")
    if args.profile:
        s = predictor.stats
        print(f"[profile] encode {s.encode_s:.2f}s audio {s.audio_s:.2f}s compress+prefill "
              f"{s.prefill_s:.2f}s decode {s.decode_s:.2f}s ({s.decode_steps} steps) "
              f"trace -> {args.profile}")
    return {"answer": answer, "ids": list(predictor.stats.last_ids), "n_frames": len(frames),
            "audio_samples": None if wav is None else len(wav),
            "load_s": load_s, "decode_s": decode_s, "answer_s": answer_s}


def main(argv=None) -> Dict[str, Any]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
