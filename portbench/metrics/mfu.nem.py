"""The nucleotide EM window's pipeline operations against the card's f32 peak."""
from portbench.readers import mfu_pct


def read(readings):
    return mfu_pct(readings)
