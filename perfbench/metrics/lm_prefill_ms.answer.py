"""LM prefill time a request: the device milliseconds of the program's
`prefill` spans (utils/profiling.py: the KV cache and the LM prefill in
serving/generate.prefill_encoded), summed over the traced slice and taken
over its `answer` spans."""

from perfbench import spans


def read(run):
    return spans.ms_per_span("prefill", "answer")
