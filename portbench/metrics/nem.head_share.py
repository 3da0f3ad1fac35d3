"""The nucleotide E-step's heads (cli/realign.record_expectations: record_jobs,
the staging and the splits) in % of the window: the program's span "head"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "head")
