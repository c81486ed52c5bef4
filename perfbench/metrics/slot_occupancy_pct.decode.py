"""Share of the engine's slot-steps that decoded a live request: the
`slot_steps` of the program's `engine.harvest` spans (utils/profiling.py:
each harvested chunk's active steps, summed over the slots) over the slots
times the steps of its `engine.dispatch` spans (`slots` x `tokens` each),
in the traced slice."""

from perfbench import spans


def read(run):
    rec = spans.recorded()
    if rec is None:
        return None
    cap = sum(s["attrs"]["slots"] * s["attrs"]["tokens"] for s in spans.of(rec, "engine.dispatch"))
    got = spans.ratio(sum(s["attrs"]["slot_steps"] for s in spans.of(rec, "engine.harvest")), cap)
    return None if got is None else 100.0 * got
