"""realign heads' banding and splits (em/discrete.collect_symbol_split_jobs)
in % of the window: the program's span "head.split"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "head.split")
