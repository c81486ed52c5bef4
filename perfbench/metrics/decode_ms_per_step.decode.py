"""DecodeEngine time a lockstep step: the engine's decode chunks (dispatch
to the harvest's device-to-host read) summed over the window's groups,
over the steps they ran (chunk_tokens a chunk, every slot)."""


def read(run):
    recs = [r for r in run.records if not r.get("error")]
    steps = sum(r["steps"] for r in recs)
    return 1e3 * sum(r["chunk_s"] for r in recs) / steps if steps else None
