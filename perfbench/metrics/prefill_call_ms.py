"""Mean host time of the prefill call, from its enqueue to its tokens on
the host (prefill_enqueue + prefill_readback), over the window's steps
that ran a chunk."""
from pbench import phases


def read(records):
    return phases.mean_ms(records, ("prefill_enqueue", "prefill_readback"),
                          ran="prefill_enqueue")
