"""Mean host time of the window's steps that ran a prefill chunk, from
the flight recorder's step records."""
from pbench import layers


def read(records):
    return layers.step_ms(records)
