"""realign tails' assembly of each record's split-job pairs
(engine/batch_align.assemble_pairs) in % of the window: the program's span
"tail.assemble"."""
from portbench.readers import span_share


def read(readings):
    return span_share(readings, "tail.assemble")
