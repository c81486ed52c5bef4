"""Compression time a request: the device milliseconds of the program's
`compress` spans (utils/profiling.py: model.prepare_multimodal_from_features,
segmentation, the Q-Former and the splice), summed over the traced slice
and taken over its `answer` spans."""

from perfbench import spans


def read(run):
    return spans.ms_per_span("compress", "answer")
