"""The program's own span recording of the traced slice, for the per-layer
readers that read it: tdc_video_tpu_torch.utils.profiling.collect() (the
spans, with host and device milliseconds, and the counters), which records
while the trace slice's torch.profiler session is active.  A program
without that recorder gives None, and its readers read nothing."""

from typing import List, Optional


def recorded() -> Optional[dict]:
    try:
        from tdc_video_tpu_torch.utils import profiling
    except ImportError:
        return None
    collect = getattr(profiling, "collect", None)
    return None if collect is None else collect()


def of(rec: dict, name: str, parent: Optional[str] = None) -> List[dict]:
    """The spans of one name (and, given, one parent's name)."""
    return [s for s in rec["spans"]
            if s["name"] == name and (parent is None or s["parent_name"] == parent)]


def ms(s: dict) -> float:
    """A span's device milliseconds, or its host milliseconds where it has
    no device interval (the CPU, where the work is done when the call
    returns)."""
    return s["device_ms"] if s["device_ms"] is not None else s["host_ms"]


def ratio(num: float, den: float) -> Optional[float]:
    return num / den if den else None


def ms_per(name: str, attr: str, parent: Optional[str] = None) -> Optional[float]:
    """The spans' milliseconds summed over their `attr` summed."""
    rec = recorded()
    if rec is None:
        return None
    got = of(rec, name, parent)
    return ratio(sum(ms(s) for s in got), sum(s["attrs"].get(attr, 0) for s in got))


def ms_per_span(name: str, per: str, host: bool = False) -> Optional[float]:
    """The spans' milliseconds (host milliseconds with host=True) summed,
    over the number of `per` spans."""
    rec = recorded()
    if rec is None:
        return None
    got = of(rec, name)
    if not got:
        return None
    total = sum(s["host_ms"] if host else ms(s) for s in got)
    return ratio(total, len(of(rec, per)))
