"""realign heads (cli/realign.record_jobs: CIGAR to anchors, the mismatch and
overlap filters, the splits and bands) in ns an anchor: the program's span
"head" over its counter "head.anchors" (the anchors the records' CIGARs
gave).  None where the program has no such counter."""


def read(readings):
    timing = readings.get("timing") or {}
    anchors, seconds = timing.get("head.anchors"), timing.get("head")
    return None if not anchors or seconds is None else 1e9 * seconds / anchors
