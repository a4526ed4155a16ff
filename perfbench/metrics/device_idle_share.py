"""Percent of the profiled stretch in which no operation ran on the device."""
from pbench import layers


def read(records):
    return layers.idle_share(records)
