"""The nucleotide E-step pipeline's least time (the forward and the stage-4
pgroups backward on the reference's band cells) over its kernels' device time."""
from portbench.readers import roofline_pct


def read(readings):
    return roofline_pct(readings)
