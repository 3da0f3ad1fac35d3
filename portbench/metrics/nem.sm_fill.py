"""The nucleotide E-step launches' problem diagonals over their SM-diagonal slots
(SMs x recursion blocks an SM holds x each launch's padded diagonals), in %:
the window's counters nem.diagonals and nem.sm_slots (em/discrete.
discrete_expectations_batched; a step off the card adds no slots)."""


def read(readings):
    timing = readings.get("timing") or {}
    slots = timing.get("nem.sm_slots")
    return 100.0 * timing.get("nem.diagonals", 0.0) / slots if slots else None
