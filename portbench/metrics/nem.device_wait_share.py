"""The host blocked on the card for the nucleotide E-step's tallies, in % of
the window: the program's span "nem.device_wait" (em/discrete.
discrete_expectations_batched, the one copy of every bucket's results)."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "nem.device_wait")
