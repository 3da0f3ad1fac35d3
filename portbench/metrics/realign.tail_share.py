"""realign_records_batched's tails (finish_record) in % of the window."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "tail")
