"""Model weight operations (port of tdc_video_tpu/cli/model_ops.py), on the
port's safetensors reader and writer:

* merge-lora: base + LoRA adapter -> a merged checkpoint directory
  (the reference's utils/merge_lora_weights.py:7-14);
* make-delta / apply-delta: target - base and base + delta
  (tdc/make_delta.py, tdc/apply_delta.py);
* consolidate: weight shards -> one safetensors file (tdc/consolidate.py).

    python -m tdc_video_tpu_torch.cli.model_ops merge-lora \\
        --model_path ckpt-lora --model_base ckpt-base --save_path merged/

export-orbax has no counterpart: the port reads no Orbax checkpoints.  Its
own training checkpoints export through train/trainer.Trainer.export_merged.
merge-lora loads on CUDA unless --device cpu; the other operations run on
the host.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from ..convert.from_hf import widen_bf16


def cmd_merge_lora(args):
    from ..builder import load_pretrained_model
    from ..convert.to_hf import save_checkpoint_dir

    name = args.model_name or os.path.basename(args.model_path)
    if "lora" not in name.lower():
        name = name + "_lora"
    _, model, _, _ = load_pretrained_model(args.model_path, args.model_base, name,
                                           load_tokenizer=False, device=args.device)
    save_checkpoint_dir(model.params, model.cfg, args.save_path)
    print(f"merged model written to {args.save_path}")


# Keys allowed to differ in shape between base and target/delta: a resized
# vocabulary changes only the embedding table and the output head (the
# reference asserts this set and combines the overlap).
_VOCAB_RESIZE_KEYS = ("embed_tokens", "lm_head")


def combine_state_dicts(primary, base, sign):
    """primary + sign * base over shared keys, the reference's delta rules:

    * a key missing from base (a new multimodal module) is carried through;
    * equal shapes combine elementwise;
    * an embed_tokens / lm_head key of another shape (a vocabulary resize)
      combines the overlapping [:rows, :cols] slice and keeps primary's
      extra rows;
    * any other shape mismatch raises ValueError;
    * more than half of primary's keys missing from base raises ValueError
      (a wrong base would pass raw primary weights through).

    bfloat16 tensors (the reader's BF16 tag) combine in f32, their exact
    values."""
    missing = [k for k in primary if k not in base]
    if primary and len(missing) > len(primary) // 2:
        raise ValueError(
            f"{len(missing)}/{len(primary)} keys missing from base (e.g. {missing[:3]}): base "
            "checkpoint does not match — combining would pass raw primary weights through")
    out = {}
    for k, v in primary.items():
        if k not in base:
            out[k] = v
            continue
        v, b = widen_bf16(v), widen_bf16(base[k])
        if b.shape == v.shape:
            out[k] = v + sign * b
        elif any(t in k for t in _VOCAB_RESIZE_KEYS) and v.ndim == b.ndim == 2:
            r = min(v.shape[0], b.shape[0])
            c = min(v.shape[1], b.shape[1])
            v = np.array(v)
            v[:r, :c] = v[:r, :c] + sign * b[:r, :c]
            out[k] = v
        else:
            raise ValueError(f"shape mismatch for {k!r}: {v.shape} vs base {b.shape} "
                             "(only embed_tokens/lm_head vocab resizes are combinable)")
    return out


def cmd_make_delta(args):
    """delta = target - base (a slice on vocabulary-resized embed/head)."""
    from ..builder import load_state_dict
    from ..convert.to_hf import save_safetensors

    delta = combine_state_dicts(load_state_dict(args.target), load_state_dict(args.base), sign=-1)
    os.makedirs(args.delta, exist_ok=True)
    save_safetensors(delta, os.path.join(args.delta, "model.safetensors"))
    for f in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        src = os.path.join(args.target, f)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.delta, f))
    print(f"delta written to {args.delta}")


def cmd_apply_delta(args):
    from ..builder import load_state_dict
    from ..convert.to_hf import save_safetensors

    out = combine_state_dicts(load_state_dict(args.delta), load_state_dict(args.base), sign=+1)
    os.makedirs(args.target, exist_ok=True)
    save_safetensors(out, os.path.join(args.target, "model.safetensors"))
    print(f"reconstructed model written to {args.target}")


def cmd_consolidate(args):
    """Merge sharded weight files into one safetensors file."""
    from ..builder import load_state_dict
    from ..convert.to_hf import save_safetensors

    sd = load_state_dict(args.src)
    os.makedirs(args.dst, exist_ok=True)
    save_safetensors(sd, os.path.join(args.dst, "model.safetensors"))
    print(f"consolidated {len(sd)} tensors -> {args.dst}")


def cmd_export_orbax(args):
    raise SystemExit(
        "export-orbax: the PyTorch port reads no Orbax checkpoints. A training run of the port "
        "saves <output_dir>/checkpoints/<step>/state.safetensors; export its merged weights with "
        "train/trainer.Trainer.export_merged (save_checkpoint_dir writes the reference layout), "
        "or convert an Orbax checkpoint with the JAX package's model_ops export-orbax.")


def main(argv=None):
    ap = argparse.ArgumentParser(description="TDC-Video model ops (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("merge-lora")
    p.add_argument("--model_path", required=True)
    p.add_argument("--model_base", required=True)
    p.add_argument("--model_name", default=None)
    p.add_argument("--save_path", required=True)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(fn=cmd_merge_lora)

    p = sub.add_parser("make-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--delta", required=True)
    p.set_defaults(fn=cmd_make_delta)

    p = sub.add_parser("apply-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--delta", required=True)
    p.add_argument("--target", required=True)
    p.set_defaults(fn=cmd_apply_delta)

    p = sub.add_parser("consolidate")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.set_defaults(fn=cmd_consolidate)

    p = sub.add_parser("export-orbax", help="not ported (exits with a message)")
    p.add_argument("--orbax_dir", required=True)
    p.add_argument("--config_dir", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--step", type=int, default=None)
    p.set_defaults(fn=cmd_export_orbax)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
