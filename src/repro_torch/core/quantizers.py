"""n-bit symmetric abs-max quantization primitives (paper §2.1).

Counterpart of ``repro/core/quantizers.py``.  INT levels span
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

