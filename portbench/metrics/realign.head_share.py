"""realign_records_batched's heads (record_jobs) in % of the window."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "head")
