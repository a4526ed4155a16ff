"""Percent of its roofline the GEMM reached over the profiled steps: their useful GEMM work at the H100's bound, over the device time of the muxq_gemm kernels."""
from pbench import layers


def read(records):
    return layers.gemm_roofline(records)
