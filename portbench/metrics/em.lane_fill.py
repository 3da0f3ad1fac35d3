"""The EM recursions' band cells over the lane cells they compute, in %: the
program's counters em.cells_band and em.cells_lane (em/sm3_em.sm3_em_step;
every step adds the same, so set-up's steps leave the ratio as it is)."""


def read(readings):
    if not readings.get("iterations"):
        return None
    from cpecan_signal_tpu_torch.utils.observability import counters
    c = counters.snapshot()
    lane = c.get("em.cells_lane")
    return 100.0 * c.get("em.cells_band", 0.0) / lane if lane else None
