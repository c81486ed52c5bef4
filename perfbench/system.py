"""The system under test, as the benchmark builds it: the port's preset,
checked against the configuration file, and the seeded weights the port
and the reference share.  The port is imported here and in the drivers
only."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import torch

from . import traffic, weights
from .reference.model import namespace


def _plain(o):
    if dataclasses.is_dataclass(o):
        return {k: _plain(v) for k, v in dataclasses.asdict(o).items()}
    if isinstance(o, torch.dtype):
        return str(o).replace("torch.", "")
    if isinstance(o, tuple):
        return [_plain(v) for v in o]
    return o


def _default(f: dataclasses.Field):
    if f.default is not dataclasses.MISSING:
        return _plain(f.default)
    if f.default_factory is not dataclasses.MISSING:
        return _plain(f.default_factory())
    return dataclasses.MISSING


def _diff(port, file, path="") -> List[str]:
    """Every key the file states, at every depth, against the port's value;
    a field of the port's dataclass that the file leaves out passes only
    where it holds that field's default (a field the port gained since)."""
    if not (dataclasses.is_dataclass(port) and isinstance(file, dict)):
        a = _plain(port)
        return [] if a == file else [f"{path.lstrip('.')}: file {file!r}, port {a!r}"]
    fields = {f.name: f for f in dataclasses.fields(port)}
    out = []
    for k in sorted(set(fields) | set(file)):
        where = f"{path}.{k}"
        if k in file:
            out += _diff(getattr(port, k, None), file[k], where)
            continue
        held, default = _plain(getattr(port, k)), _default(fields[k])
        if held != default:
            out.append(f"{where.lstrip('.')}: not in the file, port {held!r} (default {default!r})")
    return out


def port_config(cfile: Dict[str, Any]):
    """The port's TDCConfig for a configuration file: its preset, which must
    hold every size the file states (the file is the configuration as it is
    run), and its defaults in every field the file leaves out."""
    from tdc_video_tpu_torch import config as C

    cfg = getattr(C, cfile["preset"])(audio=bool(cfile.get("audio", False)))
    bad = _diff(cfg, cfile["model"])
    if bad:
        raise ValueError("the port's preset differs from the configuration file: " + "; ".join(bad))
    return cfg


class System:
    """The port's config, the model's namespace for the reference, the
    file's tokenizer, and the shared weights (bf16, made on the device from
    the seed)."""

    def __init__(self, cfile: Dict[str, Any], seed: int, device, cfg=None):
        self.cfile = cfile
        self.model = namespace(cfile["model"])
        # beside the sizes, for the counts that tokenize a request's prompt
        # again and see only the model (the drivers' `flops`)
        self.model.tokenizer = traffic.tokenizer(cfile)
        self.cfg = port_config(cfile) if cfg is None else cfg
        self.device = torch.device(device)
        t0 = time.perf_counter()
        dtype = getattr(torch, cfile.get("weights_dtype", "bfloat16"))
        self.params = weights.make(weights.spec(self.model), seed, self.device, dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.weights_s = time.perf_counter() - t0
