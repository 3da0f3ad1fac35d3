"""realign tails' AMAP reweight (core/amap.reweight_aligned_pairs) in % of
the window: the program's span "tail.reweight"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "tail.reweight")
