"""Time K1, K5 and K6 of the package on the path at the LM's causal shapes,
to compare two trees on one card.

    python scripts/torch_kernel_ab.py [--rounds 5]

Shapes: the stage-2 LM (q [1, 8192, 24, 128] over kv [1, 8192, 8, 128]),
the serving prefill (q [1, 1416, 24, 128] over kv [1, 1432, 8, 128]) and
TP's per-rank stage-3 heads (q [1, 8192, 14, 128] over kv [1, 8192, 2,
128]), all at q_offset 0, plus, where the package's kernels take a causal
query offset, the second rank's block of a 2-way sequence split (q [1,
4096, 24, 128] over kv [1, 8192, 8, 128], q_offset 4096).  Each time is
chip_smoke.time_ms's median of `rounds` CUDA-event rounds.  Prints one
JSON line: the package's location, {shape: {kernel: ms}}, and the card's
name and power limit.  Run another tree's package with PYTHONPATH set to
that tree, and compare in turns (A, B, B, A) within one call.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import sys
from pathlib import Path

import torch

sys.path.append(str(Path(__file__).resolve().parent.parent))

# name: (B, T, S, Hq, Hkv, D, q_offset)
SHAPES = {"stage2": (1, 8192, 8192, 24, 8, 128, 0), "serving": (1, 1416, 1432, 24, 8, 128, 0),
          "tp_stage3": (1, 8192, 8192, 14, 2, 128, 0), "sp_rank1": (1, 4096, 8192, 24, 8, 128, 4096)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import tdc_video_tpu_torch
    from tdc_video_tpu_torch.ops import build
    from tdc_video_tpu_torch.ops import flash_attention as fa

    build.build_all(("flash_kernel", "flash_dq_kernel", "flash_dkv_kernel"))
    has_offset = "q_offset" in inspect.signature(fa.flash_kernel).parameters
    rnd = cs._rnd_fn(cs.SEED)
    out = {}
    for name, (B, T, S, Hq, Hkv, D, off) in SHAPES.items():
        if off and not has_offset:
            continue
        kw = {"q_offset": off} if has_offset else {}
        q, k, v, do = rnd(B, T, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D), rnd(B, T, Hq, D)
        scale = 1.0 / math.sqrt(D)
        o, lse = fa.flash_kernel(q, k, v, scale, True, **kw)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()[..., None]
        args_b = (q, k, v, do, lse, delta, scale, True)
        out[name] = {
            "flash_kernel": cs.time_ms(lambda: fa.flash_kernel(q, k, v, scale, True, **kw),
                                       rounds=args.rounds),
            "flash_dq_kernel": cs.time_ms(lambda: fa.flash_dq_kernel(*args_b, **kw),
                                          rounds=args.rounds),
            "flash_dkv_kernel": cs.time_ms(lambda: fa.flash_dkv_kernel(*args_b, **kw),
                                           rounds=args.rounds),
        }
    print(json.dumps({"package": str(Path(tdc_video_tpu_torch.__file__).parent), "ms": out,
                      "card": cs.card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
