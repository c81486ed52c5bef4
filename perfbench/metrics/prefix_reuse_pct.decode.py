"""Share of the prompt rows admitted that a shared prefix saved: the
`prefix_rows_reused` of the program's `engine.admit` spans
(utils/profiling.py) over all prompt rows admitted (reused and
`rows_prefilled`), in the traced slice."""

from perfbench import spans


def read(run):
    rec = spans.recorded()
    if rec is None:
        return None
    got = spans.of(rec, "engine.admit")
    reused = sum(s["attrs"].get("prefix_rows_reused", 0) for s in got)
    rows = reused + sum(s["attrs"].get("rows_prefilled", 0) for s in got)
    share = spans.ratio(reused, rows)
    return None if share is None else 100.0 * share
