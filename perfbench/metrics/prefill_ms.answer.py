"""Compression, splice and LM prefill time of a request: the predictor's
prefill_s (ended by a device sync), the mean over the window's requests."""


def read(run):
    recs = [r for r in run.records if not r.get("error")]
    return 1e3 * sum(r["prefill_s"] for r in recs) / len(recs) if recs else None
