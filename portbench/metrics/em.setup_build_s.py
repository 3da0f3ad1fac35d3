"""Seconds of set-up in the EM bucket build: the program's span
"em.build_buckets" (em/sm3_em.build_sm3_em_buckets, both strands, with
placement and upload)."""


def read(readings):
    if not readings.get("iterations"):
        return None
    from cpecan_signal_tpu_torch.utils.observability import counters
    return counters.snapshot().get("time.em.build_buckets.sum")
