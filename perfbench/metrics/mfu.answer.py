"""Model FLOPs of every request of the window (towers, SVA, compression,
the prefill and each decode step over its cache; perfbench/flops.py) over
the window's host-clock time and the card's dense bf16 peak."""

from perfbench import flops
from perfbench.drivers import answer


def read(run):
    recs = [r for r in run.records if not r.get("error")]
    if not recs or run.window_s <= 0:
        return None
    return 100.0 * sum(answer.flops(run.model, r) for r in recs) / (run.window_s * flops.PEAK_FLOPS)
