"""Hold the port's tower attention kernels (K2, K3) to their plain versions on
the activations of chip_smoke.py's stage-2 sample, and trace what their
rounding does to the loss.

    python scripts/torch_tower_parity.py [--seeds 0 1]

For each seed: TDC-Llama3.2-3B at full size with random weights (f32 master
params from the seed) and chip_smoke.py's stage-2 sample (64 frames, made
from the seed), then the stage-2 loss three times without gradients:
attn_impl="flash" with every K2 and K3 launch also run through its plain
version; attn_impl="xla"; and "flash" with K2 and K3 replaced by their
plain versions.  Per launch: max abs error, the worst and mean error of a
row relative to its norm, and the signed error, the mean over rows of
(o - plain) . plain / |plain|^2 with its standard error (a systematic
shrink or growth of o shows as a mean many standard errors from 0; unbiased
rounding does not).  Per run: the segment boundaries that TDC compression
cut from the DINOv2 features, with the similarity margin of the last cut
chosen over the first one left out, and the visual tokens it kept; a
discrete choice that flips between runs moves the loss by far more than the
rounding that flipped it.  Runs against another tree's package and
chip_smoke.py with PYTHONPATH set to that tree.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.append(str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tower parity: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from tdc_video_tpu_torch import model as model_mod
    from tdc_video_tpu_torch.config import tdc_llama32_3b
    from tdc_video_tpu_torch.ops import flash_attention as fa
    from tdc_video_tpu_torch.ops.segment import adjacent_cosine_similarity
    from tdc_video_tpu_torch.train.stages import stage2_video_sft
    from tdc_video_tpu_torch.train.step import train_view

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(f"package {model_mod.__file__}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = tdc_llama32_3b()
    tcfg = dataclasses.replace(stage2_video_sft(), max_steps=2, report_to="none")
    names = ("full_attention_nhd", "full_attention_nhd_seqq")
    kernels = {n: getattr(fa, n) for n in names}
    plains = {n: getattr(fa, n + "_plain") for n in names}

    # what TDC compression chose in the current run
    chosen = {}
    seg_fn, comp_fn = model_mod.segment_boundaries, model_mod.compress_video

    def seg(dino, mask, k):
        sims = adjacent_cosine_similarity(dino, mask).sort().values
        kk = min(k, sims.numel() - 1)  # first left out minus last cut
        chosen["margin"] = float(sims[kk] - sims[kk - 1]) if kk > 0 else float("nan")
        chosen["boundary"] = seg_fn(dino, mask, k)
        return chosen["boundary"]

    def comp(*a, **kw):
        vis, n = comp_fn(*a, **kw)
        chosen["n_visual"] = int(n)
        return vis, n

    launches = []

    def held(name):
        def run(q, k, v, scale):
            o, r = kernels[name](q, k, v, scale), plains[name](q, k, v, scale)
            of, rf = o.float(), r.float()
            err = of - rf
            rn2 = (rf * rf).sum(-1).clamp_min(1e-12)
            row = err.norm(dim=-1) / rn2.sqrt()
            signed = (err * rf).sum(-1) / rn2
            launches.append((name, float(err.abs().max()), float(row.max()), float(row.mean()),
                             float(signed.mean()), float(signed.std() / signed.numel() ** 0.5)))
            return o
        return run

    def loss(params, batch, impl, towers):
        for n in names:
            setattr(fa, n, towers[n])
        model_mod.segment_boundaries, model_mod.compress_video = seg, comp
        try:
            with torch.no_grad():
                out = float(model_mod.tdc_loss(
                    cfg, train_view(params), batch, max_len=tcfg.model_max_length,
                    max_visual_len=tcfg.max_visual_len, attn_impl=impl, remat=True,
                    loss_chunk=tcfg.loss_chunk))
        finally:
            for n in names:
                setattr(fa, n, kernels[n])
            model_mod.segment_boundaries, model_mod.compress_video = seg_fn, comp_fn
        return out, dict(chosen)

    for seed in args.seeds:
        c.SEED = seed
        params = model_mod.init_tdc(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                                    torch.float32)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in c.train_batch(cfg, c.TRAIN_FRAMES).items()}
        for k in ("siglip_px", "dino_px"):
            batch[k] = batch[k].to(cfg.dtype)
        launches.clear()
        flash, ch_f = loss(params, batch, "flash", {n: held(n) for n in names})
        for i, (n, mx, worst, mean, signed, se) in enumerate(launches):
            print(f"seed {seed} launch {i:2d} {n}: max_abs {mx:.3e}, worst row {worst:.3e}, "
                  f"mean row {mean:.3e}, signed {signed:+.3e} (se {se:.1e}, "
                  f"{signed / max(se, 1e-30):+.1f} se)")
        for n in names:
            s = [x[4] for x in launches if x[0] == n]
            if s:
                print(f"seed {seed} {n}: {len(s)} launches, signed error mean {sum(s) / len(s):+.3e}, "
                      f"range {min(s):+.3e} .. {max(s):+.3e}")
        xla, ch_x = loss(params, batch, "xla", kernels)
        plain, ch_p = loss(params, batch, "flash", plains)
        print(f"seed {seed} loss: flash {flash:.6f}, xla {xla:.6f}, flash with K2 and K3 plain "
              f"{plain:.6f}; flash - plain towers {flash - plain:+.3e}, xla - plain towers "
              f"{xla - plain:+.3e}, flash - xla {flash - xla:+.3e}")
        for tag, ch in (("flash", ch_f), ("xla", ch_x), ("plain towers", ch_p)):
            cuts = torch.nonzero(ch["boundary"]).flatten().tolist()
            same = torch.equal(ch["boundary"], ch_p["boundary"])
            print(f"seed {seed} {tag}: segment starts {cuts}, cut margin {ch['margin']:.3e}, "
                  f"{ch['n_visual']} visual tokens; boundaries "
                  f"{'equal to' if same else 'DIFFER from'} the plain-tower run's")
        del params, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
