"""Readings that the limits of `correct` are set from, on the card, at the
cell's own sizes, all seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ... --control 3

For each seed: the weights and the cell's traffic from that seed, one
request of each size the mix cycles through (a group for answer_many)
served by the port and judged by the reference (the lower readings); for
the first --control seeds also the control, the reference in bf16 with fp8
weights put in the program's place (the upper readings).  One JSON line a
seed on stdout.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import core  # noqa: E402
from perfbench.reference import check as ref_check  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    core.env_defaults()
    import torch

    if not torch.cuda.is_available():
        core.log("no CUDA device")
        return 2
    workload, _, cfile, mix = core.cell(args.workload)
    kind = mix["driver"]
    if kind == "train":
        return calibrate_train(args, workload, cfile, mix)
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = core.driver(kind).Driver(workload, cfile, mix, seed, "cuda")
        drv.setup()
        count = len(mix["frames"]) if kind == "answer" else mix["check"]
        recs = [drv.request(i) for i in range(count)]
        drv.release()
        t1 = time.perf_counter()
        port = drv.check(recs)
        out = {"seed": seed, "port": port, "reference_s": time.perf_counter() - t1}
        if n < args.control:
            ctrl = {"token_gap": 0.0, "cut_gap": 0.0}
            for rec in drv.sample(recs):
                frames, qs = drv.inputs(rec["i"], "window")
                for j, q in enumerate([qs] if isinstance(qs, str) else qs):
                    got = ref_check.control(drv.system.model, drv.system.params, drv.tok, frames, q,
                                            rec["tokens"] if kind == "answer" else rec["tokens"][j],
                                            mix["max_new_tokens"], rec["cuts"][j], "cuda")
                    core.log(f"control seed {seed} request {rec['i']}.{j}: {got}")
                    for k in ctrl:
                        ctrl[k] = max(ctrl[k], got[k])
            out["control"] = ctrl
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


def half_the_rows():
    """The fault "half of the batch left out, the mean over the rest",
    planted in the port: every label past the first half of the sequence
    ignored by the decoder's loss."""
    from tdc_video_tpu_torch.models import lm

    loss = lm.lm_loss

    def halved(cfg, params, embeds, labels, *a, **k):
        labels = labels.clone()
        labels[:, labels.shape[1] // 2:] = -100
        return loss(cfg, params, embeds, labels, *a, **k)

    lm.lm_loss = halved
    return lambda: setattr(lm, "lm_loss", loss)


def calibrate_train(args, workload, cfile, mix) -> int:
    """Per seed: the trainer's first steps against the float32 reference
    (lower readings); for the first --control seeds also the control (the
    reference in bf16 with fp8 weights) and the trainer with half of each
    sample's rows left out of its loss (upper readings)."""
    import torch

    from perfbench.reference import model as R

    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = core.driver("train").Driver(workload, cfile, mix, seed, "cuda")
        drv.setup()
        drv.release()
        ref = drv.reference()
        torch.cuda.empty_cache()
        out = {"seed": seed, "port": drv.compare(ref)}
        if n < args.control:
            ctrl = drv.reference(R.Prec(torch.bfloat16, fp8=True))
            ctrl["change"] = {mix["reference_steps"]: ctrl["change"]}
            out["control"] = drv.compare(ref, ctrl)
            undo = half_the_rows()
            try:
                bad = core.driver("train").Driver(workload, cfile, mix, seed, "cuda", drv.system)
                bad.setup()
                bad.release()
            finally:
                undo()
            out["half_rows"] = drv.compare(ref, bad.first)
            del bad
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
