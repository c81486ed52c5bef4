"""Multi-question video QA through the continuous-batching engine (port of
tdc_video_tpu/cli/serve.py): the towers run once, and all answers decode in
one lockstep loop over KV-cache slots (serving/batching.DecodeEngine).

    python -m tdc_video_tpu_torch.cli.serve --model_path checkpoints/TDC-Llama3.2-3B \\
        --video examples/video1.mp4 --slots 4 \\
        --question "What happens first?" --question "Who appears?"

Questions can also come one per line from --questions_file.  --chat treats
them as the turns of one conversation (serving/session.ChatSession); --stream
prints tokens as the slots decode them.  Runs on CUDA unless --device cpu.
`run(args, tokenizer=...)` takes any tokenizer with encode/decode in place of
the checkpoint's transformers tokenizer.

There is no compile cache to enable, as the JAX CLI enables XLA's: eager
PyTorch compiles nothing, and the CUDA kernels are built once per checkout.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="TDC-Video multi-question serving (PyTorch/CUDA port)")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--model_base", default=None)
    ap.add_argument("--model_name", default=None)
    ap.add_argument("--video", required=True)
    ap.add_argument("--audio", default=None)
    ap.add_argument("--question", action="append", default=[],
                    help="repeatable; one request per question")
    ap.add_argument("--questions_file", default=None, help="newline-separated questions")
    ap.add_argument("--bert_tokenizer", default="./checkpoints/bert-base-uncased")
    ap.add_argument("--max_new_tokens", type=int, default=128)
    ap.add_argument("--max_frames", type=int, default=1000)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent KV-cache slots in the decode engine")
    ap.add_argument("--quantize", default=None, choices=["int8", "int8-all"])
    ap.add_argument("--kv_quant", default=None, choices=["int8"], help="int8 KV cache")
    ap.add_argument("--spec_window", type=int, default=0,
                    help="prompt-lookup speculative lockstep decode (>= 2 enables per-slot "
                         "drafting; greedy rows keep their tokens, sampled rows use rejection "
                         "sampling)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling (HF's warper order temperature -> top-k -> "
                         "top-p); 0 = greedy")
    ap.add_argument("--top_k", type=int, default=50)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed; question i draws from stream seed+i, independent of "
                         "its slot")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as slots decode them (prefixed by the question index)")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="multi-device serving: not ported (raises)")
    ap.add_argument("--chat", action="store_true",
                    help="treat the questions as sequential turns of one conversation, each "
                         "extending the previous turn's resident KV cache")
    ap.add_argument("--chat_capacity", type=int, default=None,
                    help="with --chat: the conversation's token budget (default: the first "
                         "prompt's bucket + 2048)")
    ap.add_argument("--prefill_chunk", type=int, default=0,
                    help="chunked admission: prefill long prompts N tokens per decode chunk "
                         "(0 = one-shot prefill)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _stream_printer(tok):
    """on_tokens for --stream: decode each request's whole stream and print
    what is new, holding back a trailing U+FFFD or two (a multi-byte
    character split across tokens decodes to the replacement character until
    its next token lands)."""
    printed: Dict[Any, str] = {}
    state = {"last": None}

    def on_tokens(req, new):
        text = tok.decode(req.tokens)
        stripped = text.rstrip("�")
        held = min(len(text) - len(stripped), 2)
        text = text[: len(text) - held] if held else text
        prev = printed.get(req.uid, "")
        if text.startswith(prev):
            delta = text[len(prev):]
        else:
            # the decoded stream revised characters already printed
            delta = "\n[q%s|revised] %s" % (req.uid, text)
        printed[req.uid] = text
        if not delta:
            return
        if state["last"] != req.uid:
            sys.stdout.write(f"\n[q{req.uid}] ")
            state["last"] = req.uid
        sys.stdout.write(delta)
        sys.stdout.flush()

    return on_tokens


def run(args: argparse.Namespace, tokenizer=None) -> Dict[str, Any]:
    """Load, decode, answer every question (or every turn with --chat).
    Returns the answers and the seconds of each step."""
    if args.mesh:
        raise NotImplementedError("--mesh (multi-device serving) is not ported")
    questions = list(args.question)
    if args.questions_file:
        with open(args.questions_file) as fh:
            questions += [q.strip() for q in fh if q.strip()]
    if not questions:
        raise SystemExit("no questions (use --question or --questions_file)")

    import torch

    from ..builder import load_pretrained_model
    from ..eval.runner import HFTokenizerAdapter, TDCPredictor
    from ..media.io import decode_video, load_audio

    t0 = time.time()
    hf_tok, model, _, _ = load_pretrained_model(
        args.model_path, args.model_base, args.model_name, dtype=torch.bfloat16,
        load_tokenizer=tokenizer is None, quantize=args.quantize, device=args.device)
    tok = tokenizer if tokenizer is not None else HFTokenizerAdapter(hf_tok)
    bert_tok = None
    if args.bert_tokenizer:
        try:
            from transformers import BertTokenizer

            bert_tok = BertTokenizer.from_pretrained(args.bert_tokenizer, truncation_side="right")
        except (ImportError, OSError) as e:  # no package, or no tokenizer files there
            print(f"no BERT tokenizer ({type(e).__name__}): the compression is not text-conditioned")
    load_s = time.time() - t0
    print(f"model loaded in {load_s:.1f}s")

    frames, ts = decode_video(args.video, fps=model.cfg.video_fps, max_frames=args.max_frames)
    print(f"video: {len(frames)} frames @ 1 fps; {len(questions)} questions, {args.slots} slots")
    wav = None
    if args.audio:
        wav = load_audio(args.audio)
    elif model.cfg.audio_input:
        wav = load_audio(args.video)

    predictor = TDCPredictor(model.cfg, model.params, tok, bert_tokenizer=bert_tok,
                             max_new_tokens=args.max_new_tokens, max_eval_frames=args.max_frames,
                             act_quant=args.quantize == "int8-all", spec_window=args.spec_window,
                             device=args.device)
    on_tokens = _stream_printer(tok) if args.stream else None
    out: Dict[str, Any] = {"questions": questions, "n_frames": len(frames), "load_s": load_s}

    t1 = time.time()
    if args.chat:
        sess = predictor.chat(frames, wav=wav, frame_seconds=ts, video_uid=args.video,
                              max_new_tokens=args.max_new_tokens, capacity=args.chat_capacity,
                              kv_quant=args.kv_quant, temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p, seed=args.seed,
                              on_tokens=on_tokens)
        answers, turn_s = [], []
        for i, q in enumerate(questions):
            ta = time.time()
            answers.append(sess.ask(q))
            turn_s.append(time.time() - ta)
            if args.stream:
                print()
            print(f"\n[turn {i + 1} | {turn_s[-1]:.1f}s] Q: {q}\nA: {answers[-1]}")
        sess.close()
        out.update(answers=answers, turn_s=turn_s, seconds=time.time() - t1,
                   turn_tokens=sess.turn_tokens)
        print(f"\n[{len(questions)}-turn conversation in {out['seconds']:.1f}s]")
        return out

    answers = predictor.answer_many(
        frames, questions, wav=wav, frame_seconds=ts, max_new_tokens=args.max_new_tokens,
        video_uid=args.video, num_slots=args.slots, kv_quant=args.kv_quant,
        prefill_chunk=args.prefill_chunk, on_tokens=on_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p, seed=args.seed)
    dt = time.time() - t1
    if args.stream:
        print()
    for q, a in zip(questions, answers):
        print(f"\nQ: {q}\nA: {a}")
    print(f"\n[{len(questions)} answers in {dt:.1f}s]")
    out.update(answers=answers, seconds=dt, ids=predictor.stats.last_many_ids)
    return out


def main(argv=None) -> Dict[str, Any]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
