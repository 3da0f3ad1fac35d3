"""realign heads' staging (cli/realign.stage_record_head: the rebase,
CIGAR to anchors, the mismatch filter) in % of the window: the program's
span "head.stage"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "head.stage")
