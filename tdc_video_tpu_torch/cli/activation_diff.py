"""Per-stage activation dump / diff (port of
tdc_video_tpu/cli/activation_diff.py).

`dump` runs one video (and optionally one prompt) through the model and
writes each stage's activations to an .npz under the JAX tool's keys:
siglip_feats, dino_feats (towers), frame_feats (SVA), boundaries
(segmentation), visual (compressed tokens), text_logits (the prompt's
logits; needs a tokenizer).  `diff` compares two dumps key by key, so a
dump made by the port on the card can be held against one made by the JAX
package (or the reference) on the CPU.

    python -m tdc_video_tpu_torch.cli.activation_diff dump \\
        --model_path ckpt --video v.mp4 --question "..." --out port.npz
    python -m tdc_video_tpu_torch.cli.activation_diff diff port.npz jax.npz

Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse

import numpy as np


def dump(args):
    import torch

    from ..builder import load_pretrained_model
    from ..data.images import frame_bucket, pad_frames, process_frames
    from ..eval.runner import HFTokenizerAdapter, TDCPredictor
    from ..media.io import decode_video
    from ..model import encode_frames, prepare_visual
    from ..models import lm as lm_mod
    from ..models.vit import vit_forward
    from ..ops.segment import segment_boundaries

    kw = dict(dtype=torch.bfloat16, device=args.device)
    tokenizer = None
    try:
        hf_tok, model, _, _ = load_pretrained_model(args.model_path, **kw)
        tokenizer = HFTokenizerAdapter(hf_tok)
    except Exception:
        # no tokenizer files beside the checkpoint: the text-logits stage is
        # skipped, the visual stages still dump
        _, model, _, _ = load_pretrained_model(args.model_path, load_tokenizer=False, **kw)
    cfg, params = model.cfg, model.params
    dev = torch.device(args.device)
    frames, _ = decode_video(args.video, fps=cfg.video_fps, max_frames=args.max_frames)
    sig, dino = process_frames(list(frames), cfg)
    sig, dino, fmask = pad_frames(sig, dino, frame_bucket(len(frames)))
    sig, dino = (torch.from_numpy(x).to(dev, cfg.dtype) for x in (sig, dino))
    fmask = torch.from_numpy(fmask).to(dev)

    def host(x):
        return x.detach().float().cpu().numpy()

    with torch.no_grad():
        out = {
            "siglip_feats": host(vit_forward(cfg.siglip, params["siglip"], sig, dtype=cfg.dtype)),
            "dino_feats": host(vit_forward(cfg.dino, params["dino"], dino, dtype=cfg.dtype)),
        }
        ff, df = encode_frames(cfg, params, sig, dino)
        out["frame_feats"] = host(ff)
        out["boundaries"] = segment_boundaries(
            df, fmask, cfg.compression.max_num_segments).cpu().numpy()
        qids = torch.zeros((16,), dtype=torch.int64, device=dev)
        qmask = torch.zeros((16,), dtype=torch.bool, device=dev)
        visual, n_vis = prepare_visual(cfg, params, ff, df, fmask, qids, qmask,
                                       max_visual_len=4096)
        out["visual"] = host(visual)[: int(n_vis)]
        if args.question and tokenizer is not None:
            pred = TDCPredictor(cfg, params, tokenizer, device=dev)
            ids, _, _ = pred.build_text(args.question)
            embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], torch.tensor([ids], device=dev),
                                         cfg.dtype)
            out["text_logits"] = host(lm_mod.lm_forward(cfg.lm, params["lm"], inputs_embeds=embeds,
                                                        dtype=cfg.dtype))

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: " + ", ".join(f"{k}{v.shape}" for k, v in out.items()))


def diff(args):
    """Per key: max abs and max relative difference (over b's max abs);
    0 when the worst relative difference is under --tol, else 1."""
    a = np.load(args.a)
    b = np.load(args.b)
    keys = sorted(set(a.files) & set(b.files))
    missing = sorted(set(a.files) ^ set(b.files))
    if missing:
        print(f"only in one dump: {missing}")
    worst = 0.0
    for k in keys:
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        if x.shape != y.shape:
            print(f"{k}: SHAPE {x.shape} vs {y.shape}")
            worst = np.inf
            continue
        ad = np.abs(x - y).max() if x.size else 0.0
        denom = max(np.abs(y).max(), 1e-9)
        print(f"{k}: max-abs {ad:.3e}  max-rel {ad / denom:.3e}")
        worst = max(worst, ad / denom)
    print(f"worst rel: {worst:.3e}")
    return 0 if worst < args.tol else 1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="per-stage activation dump/diff (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--model_path", required=True)
    d.add_argument("--video", required=True)
    d.add_argument("--question", default="")
    d.add_argument("--max_frames", type=int, default=1000)
    d.add_argument("--out", required=True)
    d.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c = sub.add_parser("diff")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--tol", type=float, default=3e-2)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "dump":
        dump(args)
        return 0
    return diff(args)


if __name__ == "__main__":
    raise SystemExit(main())
