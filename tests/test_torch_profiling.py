"""The port's profiling utilities (utils/profiling.py), as
tests/test_profiling.py holds the JAX package's: StageTimer accumulates and
dumps, annotate opens a named range, and trace writes a Chrome trace that
names the ranges and ops run inside it (on the CPU here)."""

import json
import os

import torch

from tdc_video_tpu_torch.utils.profiling import StageTimer, annotate, trace


def test_stage_timer_accumulates(tmp_path):
    t = StageTimer()
    with t.stage("decode"):
        sum(range(1000))
    with t.stage("decode"):
        sum(range(1000))
    out = t.timed("encode", lambda x: x * 2, torch.ones((8, 8)))
    assert out.shape == (8, 8)
    s = t.summary()
    assert s["decode"]["count"] == 2 and s["encode"]["count"] == 1
    assert s["decode"]["total_s"] >= 0
    p = str(tmp_path / "prof.json")
    t.dump(p)
    with open(p) as fh:
        assert json.load(fh)["encode"]["mean_ms"] >= 0


def test_annotate_is_usable():
    with annotate("stage-x"):
        torch.ones(4).sum()


def test_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("stage-y"):
            torch.ones((16, 16)) @ torch.ones((16, 16))
    path = os.path.join(logdir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "stage-y" in names
    assert any(n and "mm" in n for n in names)
