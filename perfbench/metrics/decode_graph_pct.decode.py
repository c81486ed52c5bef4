"""Share of DecodeEngine's decode chunks that replayed the chunk's CUDA
graph: the program's `engine.dispatch` spans of the traced slice whose
`graph` attribute is 1, over those that carry the attribute
(utils/profiling.py).  A program whose dispatch spans carry no `graph`
reads nothing."""

from perfbench import spans


def read(run):
    rec = spans.recorded()
    if rec is None:
        return None
    got = [s["attrs"]["graph"] for s in spans.of(rec, "engine.dispatch") if "graph" in s["attrs"]]
    return 100.0 * sum(got) / len(got) if got else None
