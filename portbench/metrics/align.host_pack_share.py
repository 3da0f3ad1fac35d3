"""batch_align_stream's host packing, the lazy read prep inside it, in % of
the window."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "host_pack")
