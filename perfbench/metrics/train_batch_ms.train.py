"""Host time to get a micro-step's batch onto the card: the host
milliseconds of the program's `train.batch` spans (utils/profiling.py:
Trainer.train_step's pad, share and copy), the mean over the traced
slice's `train.step` spans."""

from perfbench import spans


def read(run):
    return spans.ms_per_span("train.batch", "train.step", host=True)
