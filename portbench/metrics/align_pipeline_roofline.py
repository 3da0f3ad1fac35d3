"""The alignment pipeline's least time over its kernels' device time."""
from portbench.readers import roofline_pct


def read(readings):
    return roofline_pct(readings)
