"""realign tails after the filter (rescoring, pairs to CIGAR, the coordinate
restore, long-indel splits) in % of the window: the program's span
"tail.cigar"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "tail.cigar")
