"""Row-wise (per-token) abs-max int quantization: the hand-written CUDA
kernel (``csrc/rowwise_quantize.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/quantize.py`` (Pallas ``rowwise_quantize``).
The CUDA kernel may also fuse the MUXQ body construction that runs just
before it on the main path (``ops._permute_pad_shift``: ``x[:, gather_idx]
* in_scale``, cast back to x's dtype): pass ``gather_idx``/``in_scale``.

Bound on the H100: bytes (see the source note in the ``.cu`` file).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel, or
raises — there is no fallback.  ``LAUNCHES`` counts kernel launches;
``accounting`` sees every call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quantizers as Q
from repro_torch.kernels import accounting, build

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def body_plain(x: torch.Tensor, gather_idx: torch.Tensor,
               in_scale: torch.Tensor) -> torch.Tensor:
    """MUXQ body: channels gathered into packed order, the outlier run
    shifted down by 2^e, cast back to x's dtype (``ops._permute_pad_shift``)."""
    return (x[:, gather_idx.long()] * in_scale).to(x.dtype)


def rowwise_quantize_plain(x: torch.Tensor, bits: int = 8,
                           gather_idx: Optional[torch.Tensor] = None,
                           in_scale: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (int8 [M, K'], f32 scales [M, 1]); K' = len(gather_idx)
    when the body construction is fused in."""
    if gather_idx is not None:
        x = body_plain(x, gather_idx, in_scale)
    return Q.quantize(x, bits, granularity="per_token")


def _launch(x, bits, gather_idx, in_scale):
    global LAUNCHES
    if x.dim() != 2 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"rowwise_quantize takes f32/bf16 [M, K], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8], got {bits}")
    x = x.contiguous()
    m, k_in = x.shape
    fused = gather_idx is not None
    if fused:
        for t, dt in ((gather_idx, torch.int32), (in_scale, torch.float32)):
            if t.device != x.device or t.dtype != dt or not t.is_contiguous():
                raise ValueError("gather_idx/in_scale must be contiguous "
                                 "int32/f32 tensors on x's device")
        k_out = gather_idx.shape[0]
    else:
        k_out = k_in
    q = torch.empty((m, k_out), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rc = build.launcher("rowwise_quantize")(
            x.data_ptr(), gather_idx.data_ptr() if fused else None,
            in_scale.data_ptr() if fused else None, q.data_ptr(), s.data_ptr(),
            m, k_in, k_out, Q.qmax(bits), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "rowwise_quantize")
    LAUNCHES += 1
    return q, s


def rowwise_quantize(x: torch.Tensor, bits: int = 8,
                     gather_idx: Optional[torch.Tensor] = None,
                     in_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row abs-max quantization (optionally of the fused MUXQ body):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if (gather_idx is None) != (in_scale is None):
        raise ValueError("pass gather_idx and in_scale together")
    m, k_in = x.shape[0], x.shape[-1]
    k_out = k_in if gather_idx is None else gather_idx.shape[0]
    with accounting.site("rowwise_quantize", lambda: accounting.quantize_cost(
            m, k_in, k_out, x.element_size(), gather_idx is not None)):
        return _run(x, bits, gather_idx, in_scale)


def _run(x, bits, gather_idx, in_scale):
    if x.is_cuda:
        return _launch(x, bits, gather_idx, in_scale)
    return rowwise_quantize_plain(x, bits, gather_idx, in_scale)
