"""Percent of its roofline the paged attention reached over the profiled steps: the positions each call attends and reads, at the H100's bound, over the device time of the paged_attention kernels."""
from pbench import layers


def read(records):
    return layers.attention_roofline(records)
