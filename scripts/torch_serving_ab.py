"""Time warm `answer`s of chip_smoke.py's serving request (phase 3:
TDC-Llama3.2-3B at full size, random bf16 weights from seed 0, 16
synthetic frames, device preprocessing, 16 new tokens) for the package on
the path, to compare two trees on one card.

    python scripts/torch_serving_ab.py [--answers 5] [--check_every 1 8]

Prints one JSON line: the package's location, each answer's encode,
compress+prefill and decode seconds and decode steps, their medians, and the
card's name and power limit.  --check_every runs the answers once per value
of serving/generate.DONE_CHECK_EVERY (the decode loop's host check of its
stop condition, every step before it existed), in turns, where the package
has it.  Run another tree's package with PYTHONPATH set to that tree, and
compare in turns (A, B, B, A) within one call.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.append(str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--answers", type=int, default=5)
    ap.add_argument("--check_every", type=int, nargs="+", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_ab: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import tdc_video_tpu_torch
    from tdc_video_tpu_torch.config import tdc_llama32_3b
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.model import init_tdc
    from tdc_video_tpu_torch.ops import build
    from tdc_video_tpu_torch.serving import generate

    build.build_all()
    cfg = tdc_llama32_3b()
    dev = torch.device("cuda")
    params = init_tdc(cfg, torch.Generator(device=dev).manual_seed(cs.SEED), dev, torch.bfloat16)
    frames = cs.synth_frames(cs.SEED)
    pred = TDCPredictor(cfg, params, cs.ByteTokenizer(), bert_tokenizer=None,
                        device_preprocess=True, device=dev)
    pred.answer(frames, cs.QUESTION, max_new_tokens=cs.MAX_NEW_TOKENS)  # one-time costs
    settings = args.check_every if hasattr(generate, "DONE_CHECK_EVERY") else []
    runs = {str(k): [] for k in settings} or {"default": []}
    order = [k for i in range(args.answers) for k in (runs if i % 2 == 0 else reversed(runs))]
    for key in order:
        if key != "default":
            generate.DONE_CHECK_EVERY = int(key)
        pred.answer(frames, cs.QUESTION, max_new_tokens=cs.MAX_NEW_TOKENS)
        st = pred.stats
        runs[key].append({"encode_s": st.encode_s, "prefill_s": st.prefill_s,
                          "decode_s": st.decode_s, "decode_steps": st.decode_steps})
    out = {"package": str(Path(tdc_video_tpu_torch.__file__).parent), "runs": runs,
           "median_decode_s": {k: statistics.median(r["decode_s"] for r in v)
                               for k, v in runs.items()},
           "median_decode_ms_per_step": {
               k: statistics.median(1e3 * r["decode_s"] / max(r["decode_steps"], 1) for r in v)
               for k, v in runs.items()},
           "card": cs.card() if hasattr(cs, "card") else None}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
