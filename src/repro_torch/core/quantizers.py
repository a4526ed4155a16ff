"""n-bit symmetric abs-max quantization primitives (paper §2.1).

Counterpart of ``repro/core/quantizers.py``: quantize / dequantize, fake
quantization (the paper's quantize-dequantize protocol, §4.3), the exact
int8 x int8 -> int32 matmul and the real quantize -> int GEMM -> dequant
pipeline (Eq. 3).  INT levels span
[-(2^(b-1)-1), +(2^(b-1)-1)]; ``torch.round`` rounds half to even like
``jnp.round``, so codes match the reference bit for bit.

Granularity conventions for a 2-D matmul operand ``X[row, col]``:
  * per_tensor : one scale for the whole tensor
  * per_token  : one scale per row    (activations)
  * per_channel: one scale per column (weights W[in, out])
"""
from __future__ import annotations

from typing import Literal, Optional, Tuple

import torch

Granularity = Literal["per_tensor", "per_token", "per_channel"]

_EPS = 1e-9


def qmax(bits: int) -> int:
    """Largest representable magnitude at ``bits`` (symmetric)."""
    return (1 << (bits - 1)) - 1


def _reduce_dims(x: torch.Tensor, granularity: Granularity) -> Optional[Tuple[int, ...]]:
    if granularity == "per_tensor":
        return None
    if granularity == "per_token":
        return (x.ndim - 1,)
    if granularity == "per_channel":
        return tuple(range(x.ndim - 1))
    raise ValueError(f"unknown granularity: {granularity}")


def absmax_scale(x: torch.Tensor, bits: int,
                 granularity: Granularity = "per_tensor") -> torch.Tensor:
    """Scale s such that round(x / s) fits in ``bits`` (paper Eq. 1-2)."""
    dims = _reduce_dims(x, granularity)
    ax = torch.abs(x)
    amax = ax.amax() if dims is None else ax.amax(dim=dims, keepdim=True)
    amax = torch.clamp_min(amax.float(), _EPS)
    # divide by a tensor, not a Python number: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which is not the IEEE
    # quotient the reference (and the CUDA kernels) compute
    return amax / torch.full((), float(qmax(bits)), device=amax.device)


def quantize(x: torch.Tensor, bits: int,
             granularity: Granularity = "per_tensor",
             scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (x_int, scale).  x_int is int8 for bits <= 8, int32 otherwise."""
    if scale is None:
        scale = absmax_scale(x, bits, granularity)
    q = qmax(bits)
    xi = torch.clamp(torch.round(x.float() / scale), -q, q)
    return xi.to(torch.int8 if bits <= 8 else torch.int32), scale



def dequantize(xi: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (xi.float() * scale).to(dtype)


def fake_quant(x: torch.Tensor, bits: int,
               granularity: Granularity = "per_tensor",
               scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """quantize -> dequantize in one shot; the output keeps x's dtype."""
    xi, s = quantize(x, bits, granularity, scale=scale)
    return dequantize(xi, s, dtype=x.dtype)


def int_matmul(xi: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Integer xi [..., K] @ wi [K, N] -> the exact int32 product.

    PyTorch has no int32 GEMM on CUDA, and f32 holds only 24 bits: an
    int8 product times 2^e summed over K = 5632 does not fit.  The product
    runs in float64, whose 53 bits hold every partial sum of integers this
    size exactly (|sum| < 2^31), whatever the summation order."""
    return torch.matmul(xi.double(), wi.double()).to(torch.int32)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor, act_bits: int = 8,
                     weight_bits: int = 8,
                     act_granularity: Granularity = "per_token",
                     weight_granularity: Granularity = "per_channel",
                     out_dtype=None) -> torch.Tensor:
    """Real quantize -> INT compute -> dequantize (paper Eq. 3):
    Y = s_X * s_W * (X_int @ W_int)."""
    out_dtype = out_dtype or x.dtype
    xi, sx = quantize(x, act_bits, act_granularity)
    wi, sw = quantize(w, weight_bits, weight_granularity)
    yi = int_matmul(xi, wi)
    return (yi.float() * sx * sw).to(out_dtype)


def quant_error(x: torch.Tensor, bits: int,
                granularity: Granularity = "per_tensor") -> torch.Tensor:
    """Mean-squared fake-quantization error (Fig. 3-style analyses)."""
    return torch.mean((fake_quant(x, bits, granularity) - x) ** 2)
