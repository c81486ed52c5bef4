"""The port's span and counter recorder, its traces, and where a trace's
device idle time goes.

* `span(name, device=False, root=False, request=None, **attrs)`: a context
  manager around one call at a layer boundary.  Off (the default) it costs
  one flag check and returns a shared no-op object: no record_function, no
  CUDA event, no allocation and never a synchronize.  On, it records its
  name, host start and end (`time.perf_counter_ns`), its parent (the
  innermost span open when it opened), its request id and `attrs`; with
  device=True it also records a CUDA event pair on the current stream,
  whose elapsed time is read only by `collect`, after one synchronize
  there.  While a torch.profiler session is active each span also opens a
  `record_function` of its name, so that it lies in the Kineto trace on
  the clock of the device's kernels and copies.
* `count(name, n=1)` adds to a counter; `launch(...)` records one kernel
  launch with its shapes (ops/flash_attention.py), which `table` sums by
  kernel and shapes for the `--profile` prints.
* Recording is on inside `recording()` and whenever a torch.profiler
  session is active (torch's own fast flag,
  `torch.autograd.profiler._is_profiler_enabled`).  The start of a
  profiler session, seen by the first recorder call in it, begins a fresh
  recording, so that a reader sees that session's spans alone; the
  recording stays readable after the session ends until the next one (or
  `recording()`) begins.
* `collect()` returns the spans with their host and device milliseconds,
  the counters and the launches; `trace(logdir)` writes a Chrome trace
  (trace.json) and the recording (spans.json) of the block.
* `idle_by_span(trace.json)` reduces a Chrome trace to the device's idle
  time keyed by the innermost span open at each gap's midpoint and by the
  innermost aten op there:

      python -m tdc_video_tpu_torch.utils.profiling <logdir>/trace.json

A span's attrs may be device tensors (a count known only on the device):
`collect` reads them after its synchronize.  Attrs that cost work to
compute are set inside the block, guarded by the span's truth value:
`with span("compress", device=True) as sp: ...; if sp: sp.set(rows=n)`.

Spans share one stack across threads: the port opens spans from one thread
at a time, and a span opened by autograd's device thread during a backward
(a checkpointed region's recomputation) nests under the span that called
`backward()`.  A span's request id is its parent's, extended by `request`
where one is given; `root=True` starts a new request.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function


class _Recording:
    """What one recording holds."""

    def __init__(self):
        self.spans: List["_Span"] = []
        self.counters: Dict[str, Any] = {}
        self.launches: List[dict] = []
        self.requests = 0  # root spans so far (their request ids)


class _State:
    on = False  # inside recording()
    seen = False  # whether a profiler session was active at the recorder's last look
    rec = _Recording()
    stack: List["_Span"] = []  # spans open now, innermost last


_S = _State()


def _look() -> bool:
    """Whether to record now.  A profiler session's start, seen here first,
    begins a fresh recording unless recording() holds one."""
    prof = _autograd_profiler._is_profiler_enabled
    if prof != _S.seen:
        _S.seen = prof
        if prof and not _S.on:
            _S.rec = _Recording()
    return _S.on or prof


def enabled() -> bool:
    """Whether the recorder records now: the one guard of span, count and
    launch.  Off, three attribute reads."""
    return (_S.on or _S.seen or _autograd_profiler._is_profiler_enabled) and _look()


class _Off:
    """The span returned while the recorder is off: does nothing, is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "index", "parent", "request", "attrs", "device", "t0", "t1",
                 "events", "rf", "out")

    def __init__(self, name: str, device: bool, root: bool, request, attrs: dict):
        self.name, self.attrs, self.rec = name, attrs, _S.rec
        self.device = device
        self.parent = _S.stack[-1] if _S.stack else None
        req = self.parent.request if self.parent is not None else None
        if root:
            self.rec.requests += 1
            req = str(self.rec.requests)
        elif request is not None:
            req = str(request) if req is None else f"{req}/{request}"
        self.request = req
        self.t0 = self.t1 = None
        self.events = self.rf = self.out = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.index = len(self.rec.spans)
        self.rec.spans.append(self)
        _S.stack.append(self)
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.t1 = time.perf_counter_ns()
        stack = _S.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False

    def __bool__(self):
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def as_dict(self) -> dict:
        """The span's record; read once the device has finished its work."""
        if self.out is None and self.t1 is not None:
            parent = self.parent
            if parent is not None and parent.rec is not self.rec:
                parent = None  # opened before this recording began
            device_ms = None
            if self.events is not None:
                device_ms = float(self.events[0].elapsed_time(self.events[1]))
                self.events = None
            self.out = {"name": self.name, "index": self.index,
                        "parent": None if parent is None else parent.index,
                        "parent_name": None if parent is None else parent.name,
                        "request": self.request, "start_ns": self.t0, "end_ns": self.t1,
                        "host_ms": (self.t1 - self.t0) * 1e-6, "device_ms": device_ms,
                        "attrs": {k: _plain(v) for k, v in self.attrs.items()}}
        return self.out


def _plain(v):
    """A JSON-able value: tensors and numpy scalars read to Python numbers
    or lists."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return v.item() if v.numel() == 1 else v.tolist()
    return v.item() if isinstance(v, np.generic) else v


def span(name: str, device: bool = False, root: bool = False, request=None, **attrs):
    """One call at a layer boundary (module docstring); `with span(...) as sp`."""
    return _Span(name, device, root, request, attrs) if enabled() else _OFF


def count(name: str, n=1) -> None:
    """Add n (a number, or a device tensor read by collect) to a counter."""
    if enabled():
        c = _S.rec.counters
        c[name] = c.get(name, 0) + n


def launch(name: str, q, k, causal: bool, q_offset: int = 0, lse: bool = False) -> None:
    """Record one attention kernel launch: its name, q and k shapes, causal,
    q_offset and whether it writes the lse."""
    if enabled():
        _S.rec.launches.append({"name": name, "q": tuple(q.shape), "k": tuple(k.shape),
                                "causal": bool(causal), "q_offset": int(q_offset),
                                "lse": bool(lse)})


@contextlib.contextmanager
def recording():
    """Record over the block (a fresh recording; read it with collect())."""
    was = _S.on
    _S.rec, _S.on = _Recording(), True
    try:
        yield
    finally:
        _S.on = was


def _sync() -> None:
    """Wait for the work queued on the CUDA device, if this process used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def collect() -> dict:
    """The current recording: {"spans": [...], "counters": {...},
    "launches": [...]}.  Each finished span gives name, index, parent (the
    parent's index, or None), parent_name, request, start_ns, end_ns,
    host_ms, device_ms (None without a device interval) and attrs.  One
    synchronize first, when a span holds CUDA events or device attrs."""
    _look()
    rec = _S.rec
    _sync()
    return {"spans": [s.as_dict() for s in rec.spans if s.t1 is not None],
            "counters": {k: _plain(v) for k, v in rec.counters.items()},
            "launches": list(rec.launches)}


def totals(collected: dict) -> Dict[str, list]:
    """The recording by span name, in order of first appearance: [calls,
    host ms, device ms (None without device intervals)], summed."""
    rows: Dict[str, list] = {}
    for s in collected["spans"]:
        r = rows.setdefault(s["name"], [0, 0.0, None])
        r[0] += 1
        r[1] += s["host_ms"]
        if s["device_ms"] is not None:
            r[2] = (r[2] or 0.0) + s["device_ms"]
    return rows


def table(collected: dict) -> str:
    """totals() as a table, then the counters, then the attention launches
    by kernel and shapes, with their number."""
    lines = [f"{'span':<24} {'calls':>6} {'host ms':>11} {'device ms':>11}"]
    for name, (n, host, dev) in totals(collected).items():
        d = "-" if dev is None else f"{dev:.3f}"
        lines.append(f"{name:<24} {n:>6} {host:>11.3f} {d:>11}")
    lines += [f"{k:<24} {v}" for k, v in collected["counters"].items()]
    kinds: Dict[tuple, int] = {}
    for r in collected["launches"]:
        key = (r["name"], tuple(r["q"]), tuple(r["k"]), r["causal"], r["q_offset"], r["lse"])
        kinds[key] = kinds.get(key, 0) + 1
    for (name, q, k, causal, off, lse), n in kinds.items():
        lines.append(f"launch {name} q {list(q)} k {list(k)}" + " causal" * causal
                     + f" q_offset {off}" * (off != 0) + " lse" * lse + f" x{n}")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: `with trace("logs/run"): step()` writes
    logs/run/trace.json (open it in Perfetto or chrome://tracing), with every
    span a user annotation, and logs/run/spans.json (collect()'s recording
    of the block)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        _S.seen = True
        if not _S.on:
            _S.rec = _Recording()
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as fh:
        json.dump(collect(), fh)


# --- where the device's idle time goes ---------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(intervals: List[tuple], points: List[float]) -> List[Optional[str]]:
    """For each point (ascending), the name of the interval containing it
    that started last, or None.  intervals: (start, end, name)."""
    ivs = sorted(intervals)
    out, heap, i = [], [], 0
    for p in points:
        while i < len(ivs) and ivs[i][0] <= p:
            heapq.heappush(heap, (-ivs[i][0], ivs[i][1], ivs[i][2]))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def idle_by_span(trace_json: str, top: int = 20) -> dict:
    """The device's idle time in a Chrome trace (the gaps between its
    kernels, copies and memsets), keyed by the innermost user annotation
    (a span of the port or an annotation of its caller) open at each gap's
    midpoint, and by that span with the innermost aten op there.  Seconds:
    {"busy_s", "idle_s", "by_span": [[span, s], ...], "by_span_op":
    [["span/op", s], ...]}, largest first, `top` of each."""
    with open(trace_json) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS)
    merged: List[list] = []
    for s, e in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    mids = [0.5 * (s + e) for s, e in gaps]

    def ivs(cat):
        return [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events if e.get("cat") == cat]

    spans = _innermost(ivs("user_annotation"), mids)
    ops = _innermost(ivs("cpu_op"), mids)
    by_span: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    for (s, e), sp, op in zip(gaps, spans, ops):
        d = (e - s) * 1e-6
        sp = sp or "(no span)"
        by_span[sp] = by_span.get(sp, 0.0) + d
        key = f"{sp}/{op or '(no op)'}"
        by_op[key] = by_op.get(key, 0.0) + d

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"busy_s": busy, "idle_s": sum(e - s for s, e in gaps) * 1e-6,
            "by_span": ranked(by_span), "by_span_op": ranked(by_op)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m tdc_video_tpu_torch.utils.profiling <trace.json>", file=sys.stderr)
        return 2
    r = idle_by_span(argv[0])
    print(f"device busy {r['busy_s']:.6f} s, idle between its work {r['idle_s']:.6f} s")
    for title, key in (("idle by span", "by_span"), ("idle by span and op", "by_span_op")):
        print(title)
        for k, v in r[key]:
            print(f"  {v:12.6f} s  {k}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
