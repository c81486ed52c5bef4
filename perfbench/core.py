"""The harness core: the manifest and the files it names (a decoder family's
among them), the guard against JAX, percentiles, the device line, and the
reduction of a torch.profiler trace to busy time, idle gaps and kernel
times.

Nothing here imports the port; drivers do, once run.py has checked the card.
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package (compared whole: the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tdc_video_tpu")


def manifest() -> dict:
    with open(REPO / "BENCHMARK.json") as fh:
        return json.load(fh)


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(name: str, bench: Optional[dict] = None):
    """(workload entry, configuration entry, configuration file, mix file)."""
    bench = bench or manifest()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    c = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return w, c, read_json(REPO / c["file"]), read_json(HERE / "mixes" / f"{w['traffic']}.json")


def forbidden_modules() -> List[str]:
    held = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(held & set(FORBIDDEN))


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")


# where a decoder family's file is found by its name
LM_DIR = HERE / "lm"
_FAMILIES: Dict[Path, object] = {}


def lm_family(model):
    """perfbench/lm/<model.lm.name>.py, loaded once a process: everything
    the harness knows of the configuration's decoder (its parameter tree,
    LoRA factors, reference passes and FLOPs)."""
    path = LM_DIR / f"{model.lm.name}.py"
    if path not in _FAMILIES:
        _FAMILIES[path] = load_module(path)
    return _FAMILIES[path]


def driver(kind: str):
    """perfbench/drivers/<kind>.py, imported as a package module."""
    return importlib.import_module(f"perfbench.drivers.{kind}")


def p95(values: Sequence[float]) -> float:
    """Nearest-rank 95th percentile (the smallest value with at least 95%
    of the samples at or below it)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


# --- the profiler trace ----------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def read_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end] intervals (sorted by start) as disjoint rows."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def reduce_trace(events: List[dict], top: int = 10) -> dict:
    """busy_s (union of device activity), the device's span, the device
    operations that took most time, and the idle time between device
    activity by what the host was doing then (its innermost op, under the
    harness's span).  Times in seconds."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"busy_s": 0.0, "span_s": 0.0, "device_ops": [], "idle_gaps": [], "kernels": []}
    iv = np.array(sorted((e["ts"], e["ts"] + e["dur"]) for e in dev), dtype=np.float64)
    merged = _merge(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    gaps = np.stack([merged[:-1, 1], merged[1:, 0]], 1) if len(merged) > 1 else np.zeros((0, 2))
    idle: Dict[str, float] = {}
    if len(gaps) and host:
        hs = np.array([e["ts"] for e in host])
        he = np.array([e["ts"] + e["dur"] for e in host])
        ann = np.array([e.get("cat") == "user_annotation" for e in host])
        lengths = gaps[:, 1] - gaps[:, 0]
        for gi in np.argsort(-lengths)[:2000]:
            mid = 0.5 * (gaps[gi, 0] + gaps[gi, 1])
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            op = next((host[i]["name"] for i in sorted(inside, key=lambda i: -hs[i]) if not ann[i]), "")
            span = next((host[i]["name"] for i in sorted(inside, key=lambda i: hs[i]) if ann[i]), "")
            key = (f"{span}/{op}" if span else op) or "(no host op)"
            idle[key] = idle.get(key, 0.0) + lengths[gi] * 1e-6
        rest = float(lengths.sum()) * 1e-6 - sum(idle.values())
        if rest > 0:
            idle["(shorter gaps)"] = rest
    return {"busy_s": busy, "span_s": float(merged[-1, 1] - merged[0, 0]) * 1e-6,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
            "kernels": [(e["name"], e["dur"] * 1e-6) for e in dev if e.get("cat") == "kernel"]}


def card_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
            else f"nvidia-smi rc {out.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def env_defaults() -> None:
    """Caches inside the checkout; no library loads JAX behind the port."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / "_cache" / "torch_extensions")
