"""Mean host time of the decode call, from its enqueue to its tokens on
the host (decode_enqueue + decode_readback), over the window's steps that
ran a decode."""
from pbench import phases


def read(records):
    return phases.mean_ms(records, ("decode_enqueue", "decode_readback"),
                          ran="decode_enqueue")
