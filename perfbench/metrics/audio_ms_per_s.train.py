"""Audio encode time a second of audio: the device milliseconds of the
program's `encode.audio` spans whose parent is `train.forward`
(utils/profiling.py: model.encode_audio, fbank, BEATs and pooling) over
the seconds they encoded (each span's `seconds`), in the traced slice.
The sample's audio encode runs under a checkpoint, so a second
`encode.audio` opens under `train.backward` for its recomputation: those
are left out."""

from perfbench import spans


def read(run):
    return spans.ms_per("encode.audio", "seconds", parent="train.forward")
