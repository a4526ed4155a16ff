"""Plain-PyTorch oracles for the kernels (the paper-faithful math), the
counterpart of ``repro/kernels/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.core import quantizers as Q
from repro_torch.kernels.muxq_gemm import muxq_gemm_plain


def rowwise_quantize_ref(x: torch.Tensor, bits: int = 8):
    """Per-row (per-token) abs-max quantization: x [M, K] -> (int8 [M, K],
    scales f32 [M, 1])."""
    return Q.quantize(x, bits, granularity="per_token")


def muxq_gemm_ref(x_int, w_int, block_scale, sx, sw, block_k: int) -> torch.Tensor:
    """Oracle for the fused MUXQ GEMM (paper Eq. 7, one-GEMM form)."""
    return muxq_gemm_plain(x_int, w_int, block_scale, sx, sw, block_k)
