"""realign tails' AMAP consistency filter (core/amap.filter_pairs_to_ordered)
in ns a pair: the program's span "tail.filter" over its counter
"amap.filter_pairs" (the pairs that went into the filter).  None where the
program has no such counter."""


def read(readings):
    timing = readings.get("timing") or {}
    pairs, seconds = timing.get("amap.filter_pairs"), timing.get("tail.filter")
    return None if not pairs or seconds is None else 1e9 * seconds / pairs
