"""The port's profiling utilities (utils/profiling.py): a span opens a named
range while a profiler traces, and trace writes a Chrome trace that names
the spans and ops run inside it (on the CPU here) beside the recording."""

import json
import os

import torch

from tdc_video_tpu_torch.utils.profiling import span, trace


def test_annotate_is_usable():
    """A span (which replaced annotate) is usable off and on, and names its
    range in the profiler's trace."""
    with span("stage-x"):
        torch.ones(4).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("stage-x"):
            torch.ones(4).sum()
    assert "stage-x" in {e.key for e in prof.key_averages()}


def test_trace_writes_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with span("stage-y"):
            torch.ones((16, 16)) @ torch.ones((16, 16))
    path = os.path.join(logdir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "stage-y" in names
    assert any(n and "mm" in n for n in names)
    with open(os.path.join(logdir, "spans.json")) as fh:
        assert [s["name"] for s in json.load(fh)["spans"]] == ["stage-y"]
