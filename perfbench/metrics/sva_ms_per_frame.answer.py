"""SVA time a frame: the device milliseconds of the program's `encode.sva`
spans (utils/profiling.py: models/sva.sva_forward, the aggregator over
both towers' features) over the frames they aggregated (each span's
`frames`), in the traced slice."""

from perfbench import spans


def read(run):
    return spans.ms_per("encode.sva", "frames")
