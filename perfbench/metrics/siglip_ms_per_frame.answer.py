"""SigLIP tower time a frame: the device milliseconds of the program's
`encode.siglip` spans (utils/profiling.py: the tower's vit_forward call in
model.encode_frames) over the frames they encoded (each span's `frames`),
in the traced slice."""

from perfbench import spans


def read(run):
    return spans.ms_per("encode.siglip", "frames")
