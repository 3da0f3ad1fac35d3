"""realign tails' AMAP consistency filter (core/amap.filter_pairs_to_ordered
and the sort after it) in % of the window: the program's span
"tail.filter"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "tail.filter")
