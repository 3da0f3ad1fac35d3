"""batch_align_stream's wait on the fast lane's collection, in % of the
window."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "device_wait")
