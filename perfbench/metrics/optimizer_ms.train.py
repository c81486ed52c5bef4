"""Optimizer time: the device milliseconds of the program's
`train.optimizer` spans (utils/profiling.py: the clip and AdamW update of
Trainer.train_step), the mean per optimizer step of the traced slice."""

from perfbench import spans


def read(run):
    return spans.ms_per_span("train.optimizer", "train.optimizer")
