"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build or load, the weights made on the card
from the seed, the cell's warm-up) is timed from the start of this process
to the first timed request or step.  The window then runs the cell's
traffic for --seconds (the request or step in flight at the deadline is
finished and counted).  With --trace 1 the same run goes on to one fixed
slice of the traffic under torch.profiler, from which the per-layer
metrics are read.  Once the window has closed and the peak memory is read,
the program's state is freed and the plain reference judges what the timed
path produced (`correct`).  The last line of stdout is the JSON result;
everything else goes to stderr.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import core  # noqa: E402


def _record_launches(out: list):
    """Wrap the port's kernel launchers so that each launch's shapes are
    recorded (the roofline readers need them); returns the undo."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    fwd, bwd = fa._launch, fa._launch_bwd

    def launch(name, q, k, v, scale, causal, with_lse, q_offset=0):
        out.append({"name": name, "q": tuple(q.shape), "k": tuple(k.shape), "causal": bool(causal),
                    "q_offset": int(q_offset), "lse": bool(with_lse)})
        return fwd(name, q, k, v, scale, causal, with_lse, q_offset)

    def launch_bwd(name, q, k, v, do, lse, delta, scale, causal, q_offset=0):
        out.append({"name": name, "q": tuple(q.shape), "k": tuple(k.shape), "causal": bool(causal),
                    "q_offset": int(q_offset), "lse": False})
        return bwd(name, q, k, v, do, lse, delta, scale, causal, q_offset)

    fa._launch, fa._launch_bwd = launch, launch_bwd

    def undo():
        fa._launch, fa._launch_bwd = fwd, bwd

    return undo


class Run:
    """What a per-layer reader sees: the window's records and time, and with
    a trace the traced slice's time, reduced trace and kernel launches."""

    def __init__(self, cell, model, records, window_s):
        self.cell, self.model, self.records, self.window_s = cell, model, records, window_s
        self.slice_s, self.trace, self.launches = 0.0, None, []


def trace_slice(drv, run: Run, tmpdir: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    undo = _record_launches(run.launches)
    try:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            drv.trace_slice()
            run.slice_s = time.perf_counter() - t0
    finally:
        undo()
    path = os.path.join(tmpdir, "perfbench_trace.json")
    prof.export_chrome_trace(path)
    try:
        run.trace = core.reduce_trace(core.read_trace(path))
    finally:
        os.remove(path)


def run_cell(workload: dict, cfile: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float, bench: dict, system=None, breakage=None) -> dict:
    """One run of a cell; returns the result dict (without printing).
    `system` and `breakage` are for tests: a prebuilt System (a tiny model
    on the CPU) and a callable that breaks the timed path before set-up
    (whose first training steps the reference follows)."""
    import torch

    start_s = time.perf_counter() - t0  # interpreter, torch and the card's context
    drv = core.driver(mix["driver"]).Driver(workload, cfile, mix, seed, device, system)
    if breakage is not None:
        breakage(drv)
    drv.setup()
    parts = {"start_s": start_s, **drv.setup_parts}
    setup_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    records, window_s = drv.window(seconds)
    out = {"attempted": len(records), "failed": sum(1 for r in records if r.get("error"))}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        run = Run(workload["name"], drv.system.model, records, window_s)
        trace_slice(drv, run, os.environ.get("TMPDIR", tempfile.gettempdir()))
        metrics = {}
        for m in bench["per_layer"]:
            if workload["name"] not in m.get("workloads", [workload["name"]]):
                continue
            value = core.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = drv.end_to_end(records, window_s)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if workload["name"] in m.get("workloads", [workload["name"]])}
    drv.release()
    t_ref = time.perf_counter()
    readings = drv.check(records)
    core.log(f"reference check {time.perf_counter() - t_ref:.3f} s: {readings}")
    # the mix's limits name the numbers compared; a reading that no control
    # or fault separates from sound runs has no limit and is only logged
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in mix["limits"].items()}
    correct = out["failed"] == 0 and bool(records) and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": int(workload.get("chips", 1)), "memory_peak_bytes": int(peak)}
    res = {"correct": correct, **out, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.slice_s
        res["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    core.log(f"setup: {json.dumps({**parts, 'setup_s': setup_s})}")
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.env_defaults()
    bench = core.manifest()
    workload, _, cfile, mix = core.cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        core.log(f"needs {workload['chips']} CUDA device(s); torch.cuda.is_available() "
                 f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}")
        return 2
    try:
        import tdc_video_tpu_torch  # noqa: F401
    except ImportError as e:
        core.log(f"the port is not in this checkout: {e}")
        return 3
    torch.cuda.init()
    res = run_cell(workload, cfile, mix, args.seed, args.seconds, bool(args.trace), "cuda", T0, bench)
    core.log(f"card: {core.card_limit()}")
    bad = core.forbidden_modules()
    if bad:
        core.log(f"forbidden modules loaded in this process: {bad}")
        return 4
    for name, c in res["checks"].items():
        core.log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
