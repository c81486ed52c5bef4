"""The system under test, as the benchmark builds it: the port's preset,
checked against the configuration file, and the seeded weights the port
and the reference share.  The port is imported here and in the drivers
only."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import torch

from . import weights
from .reference.model import namespace


def _plain(o):
    if dataclasses.is_dataclass(o):
        return {k: _plain(v) for k, v in dataclasses.asdict(o).items()}
    if isinstance(o, torch.dtype):
        return str(o).replace("torch.", "")
    if isinstance(o, tuple):
        return [_plain(v) for v in o]
    return o


def _diff(a, b, path="") -> List[str]:
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b)) for d in _diff(a.get(k), b.get(k), f"{path}.{k}")]
    return [] if a == b else [f"{path.lstrip('.')}: file {b!r}, port {a!r}"]


def port_config(cfile: Dict[str, Any]):
    """The port's TDCConfig for a configuration file: its preset, which must
    hold every size the file states (the file is the configuration as it is
    run)."""
    from tdc_video_tpu_torch import config as C

    cfg = getattr(C, cfile["preset"])(audio=bool(cfile.get("audio", False)))
    port = {f.name: _plain(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    bad = _diff({k: port.get(k) for k in cfile["model"]}, cfile["model"])
    if bad:
        raise ValueError("the port's preset differs from the configuration file: " + "; ".join(bad))
    return cfg


class System:
    """The port's config, the model's namespace for the reference, and the
    shared weights (bf16, made on the device from the seed)."""

    def __init__(self, cfile: Dict[str, Any], seed: int, device, cfg=None):
        self.cfile = cfile
        self.model = namespace(cfile["model"])
        self.cfg = port_config(cfile) if cfg is None else cfg
        self.device = torch.device(device)
        t0 = time.perf_counter()
        dtype = getattr(torch, cfile.get("weights_dtype", "bfloat16"))
        self.params = weights.make(weights.spec(self.model), seed, self.device, dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.weights_s = time.perf_counter() - t0
