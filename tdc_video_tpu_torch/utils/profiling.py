"""Tracing and stage timers (port of tdc_video_tpu/utils/profiling.py).

* `trace(logdir)`: torch.profiler over the block, CPU and (where there is
  one) CUDA activity, written as a Chrome/Perfetto trace into `logdir`;
* `annotate(name)`: a named range in that trace (record_function);
* `StageTimer`: named wall-clock timers; a `timed(..., block=True)` stage
  synchronizes the device before it reads the clock, so that device time
  lands in the stage that queued it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def _sync() -> None:
    """Wait for the work queued on the CUDA device, if this process used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: `with trace("logs/run"): step()` writes
    logs/run/trace.json (open it in Perfetto or chrome://tracing)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named range inside the trace."""
    return record_function(name)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with annotate(name):
            yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def timed(self, name: str, fn, *args, block: bool = True, **kw):
        """fn(*args, **kw) as stage `name`; block=True waits for the queued
        device work before the clock is read."""
        t0 = time.perf_counter()
        with annotate(name):
            out = fn(*args, **kw)
            if block:
                _sync()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(v, 4),
                "count": self.counts[k],
                "mean_ms": round(v / max(self.counts[k], 1) * 1e3, 3),
            }
            for k, v in sorted(self.totals.items())
        }

    def dump(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)
