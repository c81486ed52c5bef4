"""Share of their roofline that the attention kernels of a training
micro-step reach over the traced slice: K2 and K3 in the frozen towers, K1
in the decoder's forward (and its recomputation), K5 with K6 in its
backward, whose pair is held to one backward's work (perfbench/flops.py)."""

from perfbench import flops

NAMES = flops.FORWARD + ("flash_dq_kernel", "flash_dkv_kernel")


def read(run):
    return flops.roofline_pct(run, NAMES, ("flash_fwd", "flash_dq", "flash_dkv"))
