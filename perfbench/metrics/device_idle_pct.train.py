"""Share of the traced slice in which no kernel, copy or memset ran on the
device (torch.profiler's device activity, its union against the slice's
host-clock length)."""


def read(run):
    if run.trace is None or run.slice_s <= 0 or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.slice_s)
