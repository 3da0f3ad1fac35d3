"""The nucleotide E-step's host staging in % of the window: the program's span
"nem.stage" (em/discrete.discrete_expectations_batched: every job's codes
and window band, the bucketing, each bucket's upload)."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "nem.stage")
