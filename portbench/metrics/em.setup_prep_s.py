"""Seconds of set-up in the program's read prep: the span "prepare_read"
(cli/vanilla_align.prepare_read, every read of the pool)."""


def read(readings):
    if not readings.get("iterations"):
        return None
    from cpecan_signal_tpu_torch.utils.observability import counters
    return counters.snapshot().get("time.prepare_read.sum")
