"""Mean host time a window's step spends with the device drained: the
scheduler's own phases (tail, admit, prefill_build, prefill_post, pages,
*_post) of each step record's host_ms."""
from pbench import phases


def read(records):
    return phases.mean_ms(records, phases.DRAINED)
