"""Matmul contexts — how quantization threads through the model.

Counterpart of ``repro/core/context.py``.  Every projection site in
``repro_torch.models`` runs as ``ctx(name, x, w)``, with eager site names
``layer{i}/attn_qkv`` etc.  Weight leaves arrive raw: a plain tensor, or a
prequantized ``{"q": int8, "s": f32}`` dict.

  FpCtx      — plain matmul.
  CollectCtx — records per-channel activation stats (calibration pass).
  QuantCtx   — resolves a per-site QuantConfig from a SitePolicy and runs
               the site on its backend: ``fp`` passthrough or ``fused``
               (the packed MUXQ kernel path, from the artifact's per-site
               kernel buffers).  The ``fake`` (quantize-dequantize)
               backend is not ported yet and raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.muxq import QuantConfig
from repro_torch.core.outliers import CalibrationStats
from repro_torch.core.policy import SitePolicy, as_policy
from repro_torch.kernels import dispatch

_SMOOTH_METHODS = ("smoothquant", "muxq_smooth")


def _is_prequant(w) -> bool:
    return isinstance(w, dict) and "q" in w


def _dense_w(w, dtype):
    """A compute-dtype dense weight from either leaf form."""
    if _is_prequant(w):
        return (w["q"].float() * w["s"]).to(dtype)
    return w.to(dtype)


class FpCtx:
    def __call__(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        return x @ _dense_w(w, x.dtype)


class CollectCtx:
    """Calibration pass: record per-channel |x| stats at every site."""

    def __init__(self, stats: Optional[CalibrationStats] = None) -> None:
        self.stats = stats or CalibrationStats()

    def __call__(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        self.stats.update(name, x)
        return x @ _dense_w(w, x.dtype)


class QuantCtx:
    def __init__(self, quant, *, device="cuda",
                 smooth_factors: Optional[Dict[str, np.ndarray]] = None,
                 kernel_buffers: Optional[Dict[str, dict]] = None) -> None:
        """``quant`` is a QuantConfig, a SitePolicy or a
        ``repro_torch.quantize.QuantArtifact`` (duck-typed: it supplies the
        policy, folded smooth factors and packed kernel buffers).  Kernel
        buffers move to ``device`` once, here."""
        if isinstance(quant, (QuantConfig, SitePolicy)):
            self.policy = as_policy(quant)
        else:
            self.policy = quant.policy
            smooth_factors = (quant.smooth_factors if smooth_factors is None
                              else smooth_factors)
            kernel_buffers = (quant.kernel_buffers if kernel_buffers is None
                              else kernel_buffers)
        self.smooth_factors = {
            k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in (smooth_factors or {}).items()}
        self.kernel_buffers = {
            site: dispatch.buffer_to(buf, device)
            for site, buf in (kernel_buffers or {}).items()}

    def __call__(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        cfg = self.policy.resolve(name)
        backend = dispatch.site_backend(cfg)
        if backend == "fp":
            return x @ _dense_w(w, x.dtype)
        if backend != "fused":
            raise NotImplementedError(
                f"site {name!r}: the {backend!r} backend is not ported yet "
                "(the port runs 'fused' and 'fp' sites)")
        if cfg.method in _SMOOTH_METHODS:
            factor = self.smooth_factors.get(name)
            if factor is None:
                raise RuntimeError(
                    f"site {name!r}: method {cfg.method!r} on the fused "
                    "backend needs folded smooth factors")
            x = (x / factor).to(x.dtype)
        buf = self.kernel_buffers.get(name)
        if buf is None:
            raise RuntimeError(
                f"site {name!r}: backend 'fused' needs packed kernel buffers "
                "— build the artifact with repro_torch.quantize."
                "pack_kernel_buffers, or load one written by the reference")
        return dispatch.fused_matmul(x, buf, act_bits=cfg.act_bits).to(x.dtype)


def as_ctx(quant, device="cuda"):
    """None | QuantConfig | SitePolicy | QuantArtifact -> a ctx."""
    if quant is None:
        return FpCtx()
    if isinstance(quant, QuantConfig):
        return FpCtx() if quant.method == "fp" else QuantCtx(quant, device=device)
    if isinstance(quant, SitePolicy):
        return FpCtx() if quant.is_fp() else QuantCtx(quant, device=device)
    return QuantCtx(quant, device=device)
