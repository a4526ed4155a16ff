"""Kernel dispatch for quantized matmul sites: backend selection, the
kernel-ready per-site buffer format and the fused execution entry points
(``fused_matmul``; ``fused_emm`` for the MoE per-expert sites).

Counterpart of ``repro/kernels/dispatch.py``.  Backends: ``fused`` (the
packed single-GEMM MUXQ path), ``fake`` (quantize-dequantize and the
real-int8 reference forms, run by ``core/context.py``) and ``fp``
(passthrough).

Buffer layout (statics derive from shapes — ``bk = K_pad / nb``):

  w_int       int8 [K_pad, N]   packed weight, outlier rows first (on
                                the device: a view of W^T [N, K_pad]);
                                per-expert sites: [E, K_pad, N], each
                                expert a view of its own W^T slab
  sw          f32  [1, N]       per-out-channel weight scales ([E, 1, N])
  block_scale int32 [K_pad/bk]  2^exp on outlier K-blocks, 1 elsewhere
  gather_idx  int32 [K_pad]     source channel per packed slot
  in_scale    f32  [K_pad]      2^-exp outlier run, 0 pad slots, 1 else

A per-expert site's experts share one outlier mask, so ``block_scale``,
``gather_idx`` and ``in_scale`` are one for all of them.

Execution (``set_fused_impl``): ``auto`` launches the CUDA kernels for
CUDA tensors and takes the plain versions for CPU tensors; ``ref`` forces
the plain oracle path (``ops.muxq_linear_ref``) on any device.

The quality observer's slot (``set_quality_observer``) lives here too.
"""
from __future__ import annotations

import contextlib
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


# Opt-in quantization-quality observer (repro_torch.obs.quality).  When
# installed, QuantCtx reports eager activations at every quantized site;
# dispatch owns the slot (as it owns _FUSED_IMPL) so that the core context
# never imports repro_torch.obs.  The reference observes only eager calls
# (its jitted serve steps carry tracers); the port's serve steps are eager
# too, so the engine runs them under ``observation_suspended()``.
_QUALITY_OBSERVER = None
_SUSPENDED = 0


def set_quality_observer(obs):
    """Install (or clear, with None) the process-wide quality observer;
    returns the previous one."""
    global _QUALITY_OBSERVER
    prev, _QUALITY_OBSERVER = _QUALITY_OBSERVER, obs
    return prev


def quality_observer():
    """The installed quality observer, or None (the default, and always
    inside ``observation_suspended()``)."""
    return None if _SUSPENDED else _QUALITY_OBSERVER


@contextlib.contextmanager
def observation_suspended():
    """No activation is observed inside this block (nestable)."""
    global _SUSPENDED
    _SUSPENDED += 1
    try:
        yield
    finally:
        _SUSPENDED -= 1


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
    """Pack one site's weight, [in_ch, out] or per expert [E, in_ch, out]
    (one outlier mask for every expert), into the fused-kernel buffer
    format: numpy arrays, the artifact's on-disk form.  A weight on the
    card packs there."""
    if cfg.method in ("muxq", "muxq_smooth") and cfg.outlier_mode != "static":
        raise ValueError(
            "fused backend needs a static calibrated outlier mask "
            "(outlier_mode='static'): channels are permuted offline")
    if w.ndim not in (2, 3):
        raise ValueError(f"cannot pack weight of rank {w.ndim}")
    k = w.shape[-2]
    mask = np.zeros(k, bool) if mask is None else np.asarray(mask, bool)
    if mask.shape != (k,):
        raise ValueError(f"mask shape {mask.shape} vs {k} input channels")
    mws = [ops.prepare_weights(we, mask, cfg.exp_factor, bk=bk,
                               weight_bits=cfg.weight_bits, k_pad_to=k_pad_to)
           for we in ([w] if w.ndim == 2 else w)]
    buf = {f: getattr(mws[0], f) for f in BUFFER_FIELDS}
    if w.ndim == 3:
        buf["w_int"] = torch.stack([m.w_int for m in mws])
        buf["sw"] = torch.stack([m.sw for m in mws])
    return {f: t.cpu().numpy() for f, t in buf.items()}


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
    w_int = np.asarray(buf["w_int"])
    return {
        "w_int": np.pad(w_int, [(0, 0)] * (w_int.ndim - 2)
                        + [(0, extra), (0, 0)]),
        "sw": np.asarray(buf["sw"]),
        "block_scale": np.concatenate(
            [np.asarray(buf["block_scale"]), np.ones(extra // bk, np.int32)]),
        "gather_idx": np.pad(np.asarray(buf["gather_idx"]), (0, extra)),
        "in_scale": np.pad(np.asarray(buf["in_scale"]), (0, extra)),
    }


def buffer_to(buf, device) -> Dict[str, torch.Tensor]:
    """A buffer dict as tensors on ``device``: contiguous, except ``w_int``,
    which keeps its logical shape [..., K_pad, N] as the transposed view of
    one contiguous k-major copy W^T [..., N, K_pad] (the layout
    ``muxq_gemm``'s kernel reads; the plain version reads any layout): a
    per-expert weight [E, K_pad, N] gives each expert a contiguous
    [N, K_pad] slab.  The transpose runs on ``device``."""
    out = {f: torch.as_tensor(np.asarray(buf[f])).to(device).contiguous()
           for f in BUFFER_FIELDS if f != "w_int"}
    w = torch.as_tensor(np.asarray(buf["w_int"])).to(device)
    out["w_int"] = w.transpose(-1, -2).contiguous().transpose(-1, -2)
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


def fused_emm(x: torch.Tensor, buf, *, act_bits: int = 8) -> torch.Tensor:
    """Per-expert fused matmul: x [E, C, K] @ a buffer with [E, ...] weight
    leaves -> [E, C, N].  Rows quantize one by one and every expert shares
    the channel map, so one ``rowwise_quantize`` over the flat [E*C, K]
    rows equals quantizing expert by expert; then one ``muxq_gemm`` per
    expert, on its rows, its k-major slab and its ``sw`` row.  ``ref``
    runs the reference's oracle form, ``ops.muxq_linear_ref`` per expert."""
    n_e, c, k = x.shape
    mws = [as_muxq_weights({**buf, "w_int": buf["w_int"][e],
                            "sw": buf["sw"][e]}) for e in range(n_e)]
    if _FUSED_IMPL == "ref":
        return torch.stack([ops.muxq_linear_ref(x[e], mw, act_bits=act_bits)
                            for e, mw in enumerate(mws)])
    x_int, sx = ops.rowwise_quantize(x.reshape(n_e * c, k), act_bits,
                                     gather_idx=buf["gather_idx"],
                                     in_scale=buf["in_scale"])
    ys = [ops.muxq_gemm(x_int[e * c:(e + 1) * c], mw.w_int, mw.block_scale,
                        sx[e * c:(e + 1) * c], mw.sw, bk=mw.bk)
          for e, mw in enumerate(mws)]
    return torch.stack(ys).to(x.dtype)
