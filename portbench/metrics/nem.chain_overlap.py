"""The nucleotide E-step's chains that run side by side, on average: the
window's problem diagonals over the sum of each launch's longest problem's
diagonals, the counters nem.diagonals and nem.chain_diagonals (em/discrete.
discrete_expectations_batched).  A program without the second counter reads
nothing."""


def read(readings):
    timing = readings.get("timing") or {}
    chains = timing.get("nem.chain_diagonals")
    return timing.get("nem.diagonals", 0.0) / chains if chains else None
