"""Tower encode time a frame: the predictor's encode_s (towers, SVA and
newline, ended by a device sync) summed over the window's requests, over
the frames they encoded."""


def read(run):
    recs = [r for r in run.records if not r.get("error")]
    frames = sum(r["frames"] for r in recs)
    return 1e3 * sum(r["encode_s"] for r in recs) / frames if frames else None
