"""Device idle share of the nucleotide EM window (torch.profiler)."""
from portbench.readers import idle_pct


def read(readings):
    return idle_pct(readings)
