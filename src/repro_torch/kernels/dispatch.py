"""Kernel dispatch for quantized matmul sites: backend selection, the
kernel-ready per-site buffer format and the fused execution entry point.

Counterpart of ``repro/kernels/dispatch.py``.  Backends: ``fused`` (the
packed single-GEMM MUXQ path), ``fake`` (quantize-dequantize and the
real-int8 reference forms, run by ``core/context.py``) and ``fp``
(passthrough).

Buffer layout (statics derive from shapes — ``bk = K_pad / nb``):

  w_int       int8 [K_pad, N]   packed weight, outlier rows first (on
                                the device: a view of W^T [N, K_pad])
  sw          f32  [1, N]       per-out-channel weight scales
  block_scale int32 [K_pad/bk]  2^exp on outlier K-blocks, 1 elsewhere
  gather_idx  int32 [K_pad]     source channel per packed slot
  in_scale    f32  [K_pad]      2^-exp outlier run, 0 pad slots, 1 else

Execution (``set_fused_impl``): ``auto`` launches the CUDA kernels for
CUDA tensors and takes the plain versions for CPU tensors; ``ref`` forces
the plain oracle path (``ops.muxq_linear_ref``) on any device.
"""
from __future__ import annotations

from typing import Dict, Literal, Optional

import numpy as np
import torch

from repro_torch.kernels import ops

Backend = Literal["fused", "fake", "fp"]
FusedImpl = Literal["auto", "ref"]

BUFFER_FIELDS = ("w_int", "sw", "block_scale", "gather_idx", "in_scale")

_FUSED_METHODS = ("naive", "muxq", "smoothquant", "muxq_smooth")

_FUSED_IMPL: FusedImpl = "auto"


def set_fused_impl(impl: FusedImpl) -> FusedImpl:
    """Select how fused-backend sites execute; returns the previous setting."""
    global _FUSED_IMPL
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown fused impl {impl!r}")
    prev, _FUSED_IMPL = _FUSED_IMPL, impl
    return prev


def site_backend(cfg) -> Backend:
    """Execution backend for one resolved site config."""
    if cfg.method == "fp":
        return "fp"
    backend = getattr(cfg, "backend", "fake")
    if backend == "fp":
        return "fp"
    if backend == "fused":
        if cfg.method not in _FUSED_METHODS:
            raise ValueError(
                f"method {cfg.method!r} has no fused kernel realization "
                f"(supported: {_FUSED_METHODS})")
        return "fused"
    if backend != "fake":
        raise ValueError(f"unknown backend {backend!r}")
    return "fake"


# ---------------------------------------------------------------------------
# Offline: kernel-ready per-site buffers
# ---------------------------------------------------------------------------

def pack_site_buffer(w, mask: Optional[np.ndarray], cfg, *, bk: int = 512,
                     k_pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack one dense site's weight ([in_ch, out]) into the fused-kernel
    buffer format (numpy arrays, the artifact's on-disk form)."""
    if cfg.method in ("muxq", "muxq_smooth") and cfg.outlier_mode != "static":
        raise ValueError(
            "fused backend needs a static calibrated outlier mask "
            "(outlier_mode='static'): channels are permuted offline")
    if w.ndim != 2:
        raise ValueError(f"cannot pack weight of rank {w.ndim} (per-expert "
                         "sites are not ported yet)")
    k = w.shape[-2]
    mask = np.zeros(k, bool) if mask is None else np.asarray(mask, bool)
    if mask.shape != (k,):
        raise ValueError(f"mask shape {mask.shape} vs {k} input channels")
    mw = ops.prepare_weights(w, mask, cfg.exp_factor, bk=bk,
                             weight_bits=cfg.weight_bits, k_pad_to=k_pad_to)
    return {f: getattr(mw, f).numpy() for f in BUFFER_FIELDS}


def buffer_k_pad(buf) -> int:
    return buf["w_int"].shape[-2]


def pad_buffer_to(buf: Dict[str, np.ndarray], k_pad: int) -> Dict[str, np.ndarray]:
    """Extend a packed buffer with whole zero K-blocks (block_scale 1,
    in_scale 0 — mathematically inert)."""
    cur = buffer_k_pad(buf)
    if cur == k_pad:
        return buf
    bk = cur // buf["block_scale"].shape[-1]
    extra = k_pad - cur
    if extra <= 0 or extra % bk:
        raise ValueError(f"cannot pad K_pad {cur} to {k_pad} by blocks of {bk}")
    return {
        "w_int": np.pad(np.asarray(buf["w_int"]), [(0, extra), (0, 0)]),
        "sw": np.asarray(buf["sw"]),
        "block_scale": np.concatenate(
            [np.asarray(buf["block_scale"]), np.ones(extra // bk, np.int32)]),
        "gather_idx": np.pad(np.asarray(buf["gather_idx"]), (0, extra)),
        "in_scale": np.pad(np.asarray(buf["in_scale"]), (0, extra)),
    }


def buffer_to(buf, device) -> Dict[str, torch.Tensor]:
    """A buffer dict as tensors on ``device``: contiguous, except ``w_int``,
    which keeps its logical shape [K_pad, N] as the transposed view of one
    contiguous k-major copy W^T [N, K_pad] (the layout ``muxq_gemm``'s
    kernel reads; the plain version reads any layout)."""
    out = {f: torch.as_tensor(np.asarray(buf[f])).to(device).contiguous()
           for f in BUFFER_FIELDS if f != "w_int"}
    w = torch.as_tensor(np.asarray(buf["w_int"]))
    out["w_int"] = w.T.contiguous().to(device).T
    return {f: out[f] for f in BUFFER_FIELDS}


def as_muxq_weights(buf) -> ops.MuxqWeights:
    """Runtime MuxqWeights view over a buffer dict of tensors."""
    k_pad = buf["w_int"].shape[-2]
    bk = k_pad // buf["block_scale"].shape[-1]
    return ops.MuxqWeights(
        w_int=buf["w_int"], sw=buf["sw"], block_scale=buf["block_scale"],
        gather_idx=buf["gather_idx"], in_scale=buf["in_scale"],
        bk=bk, k_orig=None)


# ---------------------------------------------------------------------------
# Online: fused execution
# ---------------------------------------------------------------------------

def fused_matmul(x: torch.Tensor, buf, *, act_bits: int = 8) -> torch.Tensor:
    """x [..., K] @ packed site buffer -> [..., N] via the fused MUXQ path."""
    mw = as_muxq_weights(buf)
    if _FUSED_IMPL == "ref":
        return ops.muxq_linear_ref(x, mw, act_bits=act_bits)
    return ops.muxq_linear(x, mw, act_bits=act_bits)
