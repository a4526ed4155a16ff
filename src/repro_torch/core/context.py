"""Matmul contexts — how quantization threads through the model.

Counterpart of ``repro/core/context.py``.  Every projection site in
``repro_torch.models`` runs as ``ctx(name, x, w)``, with eager site names
``layer{i}/attn_qkv`` etc.; the MoE expert sites run as
``ctx.emm(name, x, w)``: x [e, c, d] @ w [e, d, f] -> [e, c, f], the
site's math per expert, with per-expert weight scales and one outlier
mask and smoothing divisor shared by every expert.  Weight leaves arrive
raw: a plain tensor (quantize at use, the paper's fake-quant protocol),
or a prequantized ``{"q": int8, "s": f32}`` dict
(``repro_torch.core.prequant``).

  FpCtx      — plain matmul.
  CollectCtx — records per-channel activation stats (calibration pass).
  QuantCtx   — resolves a per-site QuantConfig from a SitePolicy and runs
               the site on its backend: ``fp`` passthrough, ``fake``
               (quantize-dequantize and the real-int8 reference paths of
               ``core/muxq.py``, ``core/llm_int8.py``) or ``fused`` (the
               packed MUXQ kernel path, from the artifact's per-site kernel
               buffers).  ``backend_log`` records each site's backend.

Smoothing (two vectors, as in the reference): ``smooths`` holds the
calibrated activation abs-max, from which ``qmatmul`` derives SmoothQuant
factors at use (raw weights only); ``smooth_factors`` holds the final
divisor s of a ``QuantArtifact``.  With s the ctx applies X/s itself, and
s*W on a raw weight; a prequantized or packed weight already holds Q(s*W),
so a smooth-method site with such a weight and no factor raises.
An installed quality observer (``dispatch.set_quality_observer``) sees
every quantized site's activation, as the reference's eager path does;
the serving engine suspends it around its step calls.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import quantizers as Q
from repro_torch.core.muxq import (SMOOTH_METHODS, QuantConfig, decompose,
                                   qmatmul)
from repro_torch.core.outliers import CalibrationStats
from repro_torch.core.policy import SitePolicy, as_policy
from repro_torch.kernels import dispatch


def _is_prequant(w) -> bool:
    return isinstance(w, dict) and "q" in w


def _dense_w(w, dtype):
    """A compute-dtype dense weight from either leaf form."""
    if _is_prequant(w):
        return (w["q"].float() * w["s"]).to(dtype)
    return w.to(dtype)


def _prequant_matmul(x: torch.Tensor, w, cfg: QuantConfig, mask=None) -> torch.Tensor:
    """x (fp) @ a prequantized int8 weight: int8 activations, the exact
    int GEMM, fused dequant.  MUXQ rides as the exact int32 channel
    multiplier on the activation side; the stored weight never changes."""
    muxq = mask is not None and cfg.method in ("muxq", "muxq_smooth")
    xq = decompose(x, mask, cfg.exp_factor) if muxq else x
    xi, sx = Q.quantize(xq, cfg.act_bits, cfg.act_granularity)
    if muxq:
        mult = torch.where(mask, 2 ** cfg.exp_factor, 1).to(torch.int32)
        xi = xi.to(torch.int32) * mult
    yi = Q.int_matmul(xi, w["q"])
    return (yi.float() * sx * w["s"]).to(x.dtype)


def _expert_w(w, e: int):
    """Expert ``e``'s slice of a per-expert weight leaf (either form)."""
    if _is_prequant(w):
        return {"q": w["q"][e], "s": w["s"][e]}
    return w[e]


class FpCtx:
    def __call__(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        return x @ _dense_w(w, x.dtype)

    def emm(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        return torch.bmm(x, _dense_w(w, x.dtype))


class CollectCtx:
    """Calibration pass: record per-channel |x| stats at every site."""

    def __init__(self, stats: Optional[CalibrationStats] = None) -> None:
        self.stats = stats or CalibrationStats()

    def __call__(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        self.stats.update(name, x)
        return x @ _dense_w(w, x.dtype)

    def emm(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        """Records the whole [e, c, d] dispatch buffer, its zero padding
        rows included, as the reference does (the count-weighted
        ``absmean`` counts them)."""
        self.stats.update(name, x.reshape(-1, x.shape[-1]))
        return torch.bmm(x, _dense_w(w, x.dtype))


def _on(arrays, device, dtype=None) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.array(v), dtype=dtype).to(device)
            for k, v in (arrays or {}).items()}


class QuantCtx:
    def __init__(self, quant, *, device="cuda",
                 masks: Optional[Dict[str, np.ndarray]] = None,
                 smooths: Optional[Dict[str, np.ndarray]] = None,
                 smooth_factors: Optional[Dict[str, np.ndarray]] = None,
                 kernel_buffers: Optional[Dict[str, dict]] = None) -> None:
        """``quant`` is a QuantConfig, a SitePolicy or a
        ``repro_torch.quantize.QuantArtifact`` (duck-typed: it supplies the
        policy, masks, act-absmax, folded smooth factors and packed kernel
        buffers).  Every per-site array moves to ``device`` once, here."""
        if isinstance(quant, (QuantConfig, SitePolicy)):
            self.policy = as_policy(quant)
        else:
            self.policy = quant.policy
            masks = quant.masks if masks is None else masks
            smooths = quant.act_absmax if smooths is None else smooths
            smooth_factors = (quant.smooth_factors if smooth_factors is None
                              else smooth_factors)
            kernel_buffers = (quant.kernel_buffers if kernel_buffers is None
                              else kernel_buffers)
        self.masks = _on(masks, device, torch.bool)
        self.smooths = _on(smooths, device)
        self.smooth_factors = _on(smooth_factors, device)
        self.kernel_buffers = {
            site: dispatch.buffer_to(buf, device)
            for site, buf in (kernel_buffers or {}).items()}
        self.backend_log: Dict[str, str] = {}

    @staticmethod
    def _smooth_base(cfg: QuantConfig) -> QuantConfig:
        return cfg.replace(
            method="naive" if cfg.method == "smoothquant" else "muxq")

    def __call__(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        cfg = self.policy.resolve(name)
        backend = dispatch.site_backend(cfg)
        self.backend_log[name] = backend
        if backend == "fp":
            return x @ _dense_w(w, x.dtype)
        if backend == "fused":
            return self._fused(name, x, cfg, dispatch.fused_matmul)
        return self._fake(name, x, w, cfg)

    def emm(self, name: str, x: torch.Tensor, w) -> torch.Tensor:
        """Per-expert site: x [e, c, d] @ w [e, d, f] -> [e, c, f]."""
        cfg = self.policy.resolve(name)
        backend = dispatch.site_backend(cfg)
        self.backend_log[name] = backend
        if backend == "fp":
            return torch.bmm(x, _dense_w(w, x.dtype))
        if backend == "fused":
            return self._fused(name, x, cfg, dispatch.fused_emm)
        return self._fake(name, x, w, cfg, per_expert=True)

    def _observe(self, name: str, x: torch.Tensor, cfg: QuantConfig) -> None:
        """Report the to-be-quantized activation to the installed quality
        observer (``repro_torch.obs.quality``), with the site's static mask;
        a no-op when none is installed or observation is suspended."""
        obs = dispatch.quality_observer()
        if obs is None:
            return
        mask = self.masks.get(name) if cfg.outlier_mode == "static" else None
        obs.observe_activation(
            name, x, qmax=2 ** (cfg.act_bits - 1) - 1,
            mask=None if mask is None else mask.cpu().numpy())

    def _missing_factor(self, name: str, cfg: QuantConfig, backend: str):
        return RuntimeError(
            f"site {name!r}: method {cfg.method!r} on the {backend!r} "
            "backend needs folded smooth factors (build the artifact "
            "with repro_torch.quantize.quantize_model)")

    def _fused(self, name: str, x: torch.Tensor, cfg: QuantConfig, matmul):
        """The packed kernel path: X/s on smooth sites (the buffer holds
        Q(s*W)), then ``matmul`` (``dispatch.fused_matmul``, or
        ``fused_emm`` per expert)."""
        if cfg.method in SMOOTH_METHODS:
            factor = self.smooth_factors.get(name)
            if factor is None:
                raise self._missing_factor(name, cfg, "fused")
            x = (x / factor).to(x.dtype)
        self._observe(name, x, cfg)
        buf = self.kernel_buffers.get(name)
        if buf is None:
            raise RuntimeError(
                f"site {name!r}: backend 'fused' needs packed kernel "
                "buffers — build the artifact with repro_torch.quantize."
                "quantize_model, or load one written by either package")
        return matmul(x, buf, act_bits=cfg.act_bits).to(x.dtype)

    def _fake(self, name: str, x: torch.Tensor, w, cfg: QuantConfig,
              per_expert: bool = False):
        """Quantize-dequantize and the real-int8 reference forms, on a raw
        or prequantized weight (``per_expert``: each expert's slice on its
        own, as the reference's vmap over experts)."""
        mask = self.masks.get(name) if cfg.outlier_mode == "static" else None
        if cfg.method in SMOOTH_METHODS:
            factor = self.smooth_factors.get(name)
            if factor is not None:
                x = (x / factor).to(x.dtype)
                cfg = self._smooth_base(cfg)
                if not _is_prequant(w):     # [.., d, f]: s over the rows
                    w = (w * factor[:, None]).to(w.dtype)
            elif _is_prequant(w):
                raise self._missing_factor(name, cfg, "fake")
            # else: quantize at use; qmatmul derives factors from the hint
        self._observe(name, x, cfg)
        hint = self.smooths.get(name)

        def one(x_, w_):
            if _is_prequant(w_):
                return _prequant_matmul(x_, w_, cfg, mask)
            return qmatmul(x_, w_.to(x_.dtype), cfg, mask=mask, smooth=hint)
        if per_expert:
            return torch.stack([one(x[e], _expert_w(w, e))
                                for e in range(x.shape[0])])
        return one(x, w)


def as_ctx(quant, device="cuda"):
    """None | QuantConfig | SitePolicy | QuantArtifact -> a ctx."""
    if quant is None:
        return FpCtx()
    if isinstance(quant, QuantConfig):
        return FpCtx() if quant.method == "fp" else QuantCtx(quant, device=device)
    if isinstance(quant, SitePolicy):
        return FpCtx() if quant.is_fp() else QuantCtx(quant, device=device)
    return QuantCtx(quant, device=device)
