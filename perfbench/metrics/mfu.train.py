"""Model FLOPs of the window's micro-steps (the frozen towers and BEATs
forward, the trainable SVA, compression and audio_proj forward and
backward, the decoder forward and its input gradients, LoRA's factors and
the head over the non-pad rows; recomputation not counted;
perfbench/flops.py) over the window's host-clock time and the card's dense
bf16 peak."""

from perfbench import flops
from perfbench.drivers import train


def read(run):
    recs = [r for r in run.records if "rows" in r]
    if not recs or run.window_s <= 0:
        return None
    return 100.0 * sum(train.flops(run.model, r) for r in recs) / (run.window_s * flops.PEAK_FLOPS)
