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


def muxq_gemm_two_matmul_ref(x_int, w_int, block_scale, sx, sw,
                             block_k: int) -> torch.Tensor:
    """The literal paper form, a second independent oracle for the fused
    GEMM: Y_body + (2^e - 1) * Y_aux, with Aux the outlier channels of the
    same integer activations (shared scales).  Both integer products run
    through ``quantizers.int_matmul`` (exact in float64)."""
    mask_k = torch.repeat_interleave(block_scale > 1, block_k)
    scale_k = torch.repeat_interleave(block_scale, block_k).to(torch.int32)
    xi = x_int.to(torch.int32)
    y_body = Q.int_matmul(xi, w_int)
    aux = torch.where(mask_k[None, :], xi, 0) * (scale_k - 1)[None, :]
    y_aux_scaled = Q.int_matmul(aux, w_int)
    return (y_body + y_aux_scaled).float() * sx * sw
