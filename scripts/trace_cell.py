"""Where a benchmark cell's device idle time goes, by the program's spans,
and what the span recorder costs when it is on.

    python scripts/trace_cell.py --workload qa_open_answers --seed 7 [--logdir DIR]

Runs the cell's set-up as perfbench/run.py does (its driver, unchanged),
then the cell's trace slice (perfbench's `trace_slice`) in turns with the
recorder off and under utils.profiling.recording() (no profiler), `--repeats`
times each, then once under utils.profiling.trace (torch.profiler and the
recorder), which writes trace.json and spans.json into --logdir.  Every
slice starts from the same state: the predictor's one-video feature cache
is emptied first, so that each slice encodes its videos, and the training
driver starts each slice at the same micro-step (the same samples).  Prints a
table of the traced slice's spans and one JSON line: the card, each
slice's seconds, utils.profiling.idle_by_span of the trace, and the
span-reading per-layer metrics (perfbench/spans.py) of the recording-only
slice and of the traced one, and the engine's host readings of both:
`engine.dispatch` host ms a decode step and `engine.admit`'s mean
`queue_wait_s` in ms.  Those two are left out of the benchmark: its traced
slice runs under torch.profiler, whose cost per op lands in the host's
enqueue, so only the recording-only slice reads them as the program runs.
Needs a CUDA device.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import core  # noqa: E402


def _span_metrics(bench: dict, cell: str) -> dict:
    out = {}
    for m in bench["per_layer"]:
        reader = core.metric_reader(m["name"])
        if cell in m.get("workloads", [cell]) and "spans" in reader.__dict__:
            out[m["name"]] = reader.read(None)
    return out


def _engine(rec: dict) -> dict:
    """The DecodeEngine's host readings of a recording (module docstring);
    empty where no engine ran."""
    disp = [s for s in rec["spans"] if s["name"] == "engine.dispatch"]
    waits = [s["attrs"]["queue_wait_s"] for s in rec["spans"]
             if s["name"] == "engine.admit" and "queue_wait_s" in s["attrs"]]
    if not disp:
        return {}
    return {"dispatch_ms_per_step": sum(s["host_ms"] for s in disp)
            / sum(s["attrs"]["tokens"] for s in disp),
            "queue_wait_ms": 1e3 * sum(waits) / len(waits) if waits else None}


def measure(drv, bench: dict, cell: str, repeats: int, logdir: str) -> dict:
    """The slices of a driver whose set-up has run (module docstring)."""
    from tdc_video_tpu_torch.utils import profiling

    import torch

    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    micro = getattr(drv, "micro", None)

    def one_slice(ctx) -> float:
        if hasattr(drv, "pred"):
            drv.pred._feat_cache = (None, None)
        if micro is not None:  # the training driver: the same samples each slice
            drv.micro = micro
        sync()
        t0 = time.perf_counter()
        with ctx:
            drv.trace_slice()
            sync()
        return time.perf_counter() - t0

    off, on, recorded, totals, engine = [], [], {}, {}, {}
    for i in range(repeats):  # off, on, on, off, ...
        for mode in ("off", "on") if i % 2 == 0 else ("on", "off"):
            if mode == "off":
                off.append(one_slice(contextlib.nullcontext()))
            else:
                on.append(one_slice(profiling.recording()))
                recorded = _span_metrics(bench, cell)
                totals = profiling.totals(profiling.collect())
                engine = _engine(profiling.collect())
    traced_s = one_slice(profiling.trace(logdir))  # with the trace's export
    traced = _span_metrics(bench, cell)
    print(profiling.table(profiling.collect()), file=sys.stderr)
    return {"slice_s_off": off, "slice_s_recording": on, "slice_s_traced_and_written": traced_s,
            "idle_by_span": profiling.idle_by_span(os.path.join(logdir, "trace.json")),
            "metrics_recording": recorded, "spans_recording": totals,
            "engine_recording": engine, "metrics_traced": traced,
            "spans_traced": profiling.totals(profiling.collect()),
            "engine_traced": _engine(profiling.collect()), "logdir": logdir}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--logdir", default=None,
                    help="where trace.json and spans.json go (default: a temp dir)")
    args = ap.parse_args(argv)
    core.env_defaults()
    bench = core.manifest()
    workload, _, cfile, mix = core.cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available():
        core.log("needs a CUDA device")
        return 2
    drv = core.driver(mix["driver"]).Driver(workload, cfile, mix, args.seed, "cuda", None)
    t = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t
    res = measure(drv, bench, workload["name"], args.repeats,
                  args.logdir or tempfile.mkdtemp(prefix="trace_cell_"))
    print(json.dumps({"workload": workload["name"], "seed": args.seed, "card": core.card_limit(),
                      "setup_s": setup_s, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
