"""The EM recursion launches' problem diagonals over their SM-diagonal slots
(SMs x recursion blocks an SM holds x each launch's padded diagonals), in
%: the program's counters em.diagonals and em.sm_slots (em/sm3_em.
sm3_em_step; a step on the CPU adds no slots)."""


def read(readings):
    if not readings.get("iterations"):
        return None
    from cpecan_signal_tpu_torch.utils.observability import counters
    c = counters.snapshot()
    slots = c.get("em.sm_slots")
    return 100.0 * c.get("em.diagonals", 0.0) / slots if slots else None
