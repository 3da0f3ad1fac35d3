"""The nucleotide E-step's band cells over the lane cells its launches hold (B x
Dp x W a bucket), in %: the window's counters nem.cells_band and
nem.cells_lane (em/discrete.discrete_expectations_batched)."""


def read(readings):
    timing = readings.get("timing") or {}
    lane = timing.get("nem.cells_lane")
    return 100.0 * timing.get("nem.cells_band", 0.0) / lane if lane else None
