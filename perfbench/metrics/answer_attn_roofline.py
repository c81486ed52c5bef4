"""Share of their roofline that the attention kernels the answer path
launches (K1 in the LM prefill, K2 in DINOv2, K3 in SigLIP) reach over the
traced slice: the sum of each launch's bound from its shapes
(perfbench/flops.py) over the device time of the forward kernels."""

from perfbench import flops


def read(run):
    return flops.roofline_pct(run, flops.FORWARD, ("flash_fwd",))
