"""Kernel launches a scheduler step (the port's LAUNCHES counters of the quantize, GEMM and paged-attention wrappers) over the window."""
from pbench import layers


def read(records):
    return layers.launches_per_step(records)
