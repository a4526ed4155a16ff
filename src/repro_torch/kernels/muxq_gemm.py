"""Fused MUXQ int8 GEMM with per-K-block exponent scaling (paper Eq. 7):
the hand-written CUDA kernel (``csrc/muxq_gemm.cu``, int8 tensor-core MMA,
split-K within a thread block cluster) and its plain PyTorch version.

Counterpart of ``repro/kernels/muxq_gemm.py`` (Pallas ``muxq_gemm``)::

    Y = (sum_kb block_scale[kb] * X_int[:, kb] @ W_int[kb, :]) * sx * sw

The kernel reads the weight k-major: ``w_int`` [K, N] must be the
transposed view of a contiguous W^T [N, K] (``w_int.T.is_contiguous()``),
the layout ``dispatch.buffer_to`` gives the served copy.  Bound on the H100
at the serving M: the K*N weight bytes (see the source note in the ``.cu``
file); the kernel's C entry plans its own grid (K split across the blocks
of a thread block cluster) from the shape and the card's SM count.  A CPU
tensor takes the plain version (any layout); a CUDA tensor
launches the kernel, or raises — there is no fallback and no copy.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = 0

_BK_TILE = 64   # the kernel's K tile: must divide the artifact's block width


def accumulate_plain(x_int: torch.Tensor, w_int: torch.Tensor,
                     block_scale: torch.Tensor, bk: int) -> torch.Tensor:
    """The int32 accumulator sum_kb block_scale[kb] * X[:, kb] @ W[kb, :].

    Each block's product runs in float64, which holds every partial sum
    exactly (|partial| <= 127 * 127 * bk << 2^53), so this is exact on any
    device — integer matmul has no CUDA kernel in PyTorch."""
    m, k = x_int.shape
    n = w_int.shape[1]
    nb = k // bk
    xb = x_int.reshape(m, nb, bk).double()
    wb = w_int.reshape(nb, bk, n).double()
    per_block = torch.einsum("mbk,bkn->bmn", xb, wb).to(torch.int64)
    acc = (per_block * block_scale.to(torch.int64)[:, None, None]).sum(0)
    return acc.to(torch.int32)


def muxq_gemm_plain(x_int, w_int, block_scale, sx, sw, bk: int) -> torch.Tensor:
    """Plain version: x_int [M, K] int8, w_int [K, N] int8, block_scale
    [K/bk] int32, sx [M, 1] f32, sw [1, N] f32 -> f32 [M, N]."""
    acc = accumulate_plain(x_int, w_int, block_scale, bk)
    return acc.float() * sx * sw


def _launch(x_int, w_int, block_scale, sx, sw, bk):
    global LAUNCHES
    m, k = x_int.shape
    k2, n = w_int.shape
    if k != k2 or k % bk or block_scale.shape != (k // bk,):
        raise ValueError(f"K={k} (w: {k2}) must tile by bk={bk} with one "
                         "scale per block")
    if bk % _BK_TILE:
        raise ValueError(f"the CUDA kernel's K tile ({_BK_TILE}) must divide "
                         f"bk={bk}")
    if not w_int.T.is_contiguous():
        raise ValueError("muxq_gemm's kernel reads the weight k-major: w_int "
                         f"[K, N] must be the transposed view of a contiguous "
                         f"[N, K] tensor (strides {w_int.stride()}); "
                         "dispatch.buffer_to stores the served copy so")
    want = ((x_int, torch.int8), (w_int.T, torch.int8),
            (block_scale, torch.int32), (sx, torch.float32), (sw, torch.float32))
    for t, dt in want:
        if t.device != x_int.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("muxq_gemm takes contiguous int8/int8/int32/f32/"
                             "f32 operands on one device")
    if sx.numel() != m or sw.numel() != n:
        raise ValueError(f"scales: sx {tuple(sx.shape)} vs M={m}, "
                         f"sw {tuple(sw.shape)} vs N={n}")
    if x_int.data_ptr() % 16 or w_int.data_ptr() % 16:
        raise ValueError("x_int and w_int must be 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.float32, device=x_int.device)
    rc = build.launcher("muxq_gemm")(
            x_int.data_ptr(), w_int.data_ptr(), block_scale.data_ptr(),
            sx.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, k, bk,
            build.sm_count(x_int.device),
            torch.cuda.current_stream(x_int.device).cuda_stream)
    build.check(rc, "muxq_gemm")
    LAUNCHES += 1
    return out


def muxq_gemm(x_int, w_int, block_scale, sx, sw, *, bk: int = 512) -> torch.Tensor:
    """Y = dequant(sum_kb block_scale[kb] * X[:, kb] @ W[kb, :]) in f32:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x_int.is_cuda:
        return _launch(x_int, w_int, block_scale, sx, sw, bk)
    return muxq_gemm_plain(x_int, w_int, block_scale, sx, sw, bk)
