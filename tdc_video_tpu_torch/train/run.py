"""Training entry point (port of tdc_video_tpu/train/run.py, one device).

    python -m tdc_video_tpu_torch.train.run --stage 3 \
        --model_path checkpoints/stage2-out --data_path data.json \
        --image_folder /data/videos --output_dir checkpoints/stage3-out

Runs on CUDA unless `--device cpu`.  Resumes from the newest checkpoint
under --output_dir, trains, and writes the merged model (LoRA baked in) in
the reference layout to <output_dir>/final.  Multi-process training
(--coordinator, --num_processes, --process_id) is not ported; JAX's
persistent XLA compile cache (utils/cache.py) has no counterpart here
(eager PyTorch compiles nothing).
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="TDC-Video trainer (PyTorch/CUDA)")
    ap.add_argument("--stage", type=int, choices=(1, 2, 3), default=2)
    ap.add_argument("--model_path", required=True, help="checkpoint dir to start from")
    ap.add_argument("--data_path", required=True, help="supervised JSON")
    ap.add_argument("--image_folder", default="")
    ap.add_argument("--audio_folder", default="")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--bert_tokenizer", default="./checkpoints/bert-base-uncased")
    ap.add_argument("--learning_rate", type=float, default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--max_train_frames", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--model_max_length", type=int, default=None)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--coordinator", default=None,
                    help="multi-process coordinator address (not ported)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the training run into LOGDIR")
    ap.add_argument("--report_to", default=None, choices=["jsonl", "tensorboard", "none"],
                    help="override the stage preset's metrics sink")
    ap.add_argument("--quantize_frozen", default=None, choices=["int8"],
                    help="store the frozen base (LM minus embeddings, frozen towers) as "
                         "weight-only int8 during LoRA training (QLoRA)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, tokenizer=None):
    """Train from the command line's flags.  `tokenizer` (encode) replaces the
    checkpoint's transformers tokenizer when given.  Returns the Trainer."""
    args = parse_args(argv)
    if args.coordinator or args.num_processes or args.process_id is not None:
        raise NotImplementedError("multi-process training is not ported: one device "
                                  "(ROADMAP.md queue 1 item 6, slice 13)")

    from ..builder import load_pretrained_model
    from ..convert.to_hf import save_checkpoint_dir
    from .dataset import Collator, SupervisedDataset, data_iterator
    from .runner_utils import hf_tokenizer_protocol
    from .stages import STAGES
    from .trainer import Trainer

    tcfg = STAGES[args.stage](args.output_dir)
    overrides = {}
    for f in ("learning_rate", "max_steps", "max_train_frames", "model_max_length"):
        v = getattr(args, f)
        if v is not None:
            overrides[f] = v
    if args.batch_size is not None:
        overrides["per_device_train_batch_size"] = args.batch_size
    if args.report_to is not None:
        overrides["report_to"] = args.report_to
    if args.quantize_frozen is not None:
        overrides["quantize_frozen"] = args.quantize_frozen
    tcfg = dataclasses.replace(tcfg, output_dir=args.output_dir, **overrides)

    hf_tok, model, _, _ = load_pretrained_model(args.model_path, load_tokenizer=tokenizer is None,
                                                device=args.device)
    tokenizer = tokenizer if tokenizer is not None else hf_tokenizer_protocol(hf_tok)
    bert_tok = None
    if args.bert_tokenizer:
        try:
            from transformers import BertTokenizer

            bert_tok = BertTokenizer.from_pretrained(args.bert_tokenizer, truncation_side="right")
        except (ImportError, OSError) as e:  # no package, or no tokenizer files there
            print(f"no BERT tokenizer ({type(e).__name__}): the compression is not text-conditioned")

    ds = SupervisedDataset(args.data_path, model.cfg, tokenizer, image_folder=args.image_folder,
                           audio_folder=args.audio_folder, max_frames=tcfg.max_train_frames)
    steps_per_epoch = max(1, len(ds) // tcfg.per_device_train_batch_size)
    total = tcfg.max_steps or steps_per_epoch * tcfg.num_train_epochs

    trainer = Trainer(model.cfg, tcfg, model.params, total_steps=total, device=args.device)
    # the trainer owns (and under --quantize_frozen replaces) the param tree:
    # drop the loader's reference, so the float base is freed there
    model.params = None
    start_step = 0
    if args.resume and trainer.restore_if_available():
        start_step = trainer.step
        print(f"resumed at step {start_step}")

    collator = Collator(model.cfg, bert_tokenizer=bert_tok, max_len=tcfg.model_max_length,
                        max_frames=tcfg.max_train_frames)
    batches = data_iterator(ds, collator, batch_size=trainer.n_data * tcfg.per_device_train_batch_size,
                            seed=tcfg.seed, epochs=tcfg.num_train_epochs,
                            group_by_modality_length=tcfg.group_by_modality_length,
                            start_step=start_step)
    try:
        if args.profile:
            from ..utils.profiling import trace

            with trace(args.profile):
                trainer.fit(batches)
        else:
            trainer.fit(batches)
    finally:
        trainer.close()

    # the final artifact in the reference layout (LoRA baked in), beside the
    # training checkpoints (the reference's save_pretrained, train.py:1277-1294)
    final = os.path.join(tcfg.output_dir, "final")
    save_checkpoint_dir(trainer.export_merged(), model.cfg, final)
    print(f"done at step {trainer.step}; checkpoints in {tcfg.output_dir}; final model in {final}")
    return trainer


if __name__ == "__main__":
    main()
