"""MUXQ — Mixed-to-Uniform Precision Matrix Quantization (paper §3).

Counterpart of ``repro/core/muxq.py``.  For outlier channel set M and
``exp_factor`` e (paper Eq. 4-6):

    Body = X with outlier columns divided by 2^e       (exponent shift)
    Aux  = Body restricted to outlier columns
    X    = Body + (2^e - 1) * Aux                      (exact)

so the matmul splits into two uniform-precision INT GEMMs (Eq. 7).  Two
execution forms: ``paper`` (Body and Aux quantized independently and
multiplied separately) and ``fused`` (one quantization of Body; the
outlier columns' int32 contribution scaled by 2^e — one GEMM, the form
the packed kernel path runs).  Both have a fake-quant form (the paper's
evaluation protocol) and a real-int8 form; :func:`qmatmul` dispatches
every method of the paper's Table 1 from a :class:`QuantConfig`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.core import outliers as O
from repro_torch.core import quantizers as Q

Method = Literal["fp", "naive", "muxq", "llm_int8", "smoothquant", "muxq_smooth"]
SMOOTH_METHODS = ("smoothquant", "muxq_smooth")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization policy for one matmul site, field for field the
    reference's (a policy serialized by either package loads in the
    other).  ``method`` says what math to apply; ``backend`` how to
    execute it (``fused`` = the packed single-GEMM MUXQ kernel path,
    ``fake`` = quantize-dequantize and the real-int8 reference paths,
    ``fp`` = passthrough)."""
    method: Method = "muxq"
    backend: Literal["fake", "fused", "fp"] = "fake"
    act_bits: int = 8
    weight_bits: int = 8
    act_granularity: Q.Granularity = "per_tensor"
    weight_granularity: Q.Granularity = "per_tensor"
    exp_factor: int = 2                 # paper §3.3: 2 under the |x|>6 criterion
    outlier_threshold: float = O.DEFAULT_THRESHOLD
    outlier_mode: Literal["dynamic", "static"] = "dynamic"
    muxq_form: Literal["paper", "fused"] = "paper"
    real_int8: bool = False             # False = fake quant (paper protocol)
    smooth_alpha: float = 0.5           # SmoothQuant migration strength

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


FP16 = QuantConfig(method="fp")


def _as_mask(mask, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(mask, dtype=torch.bool, device=x.device)


# ---------------------------------------------------------------------------
# Decomposition
# ---------------------------------------------------------------------------

def decompose(x: torch.Tensor, mask, exp_factor: int) -> torch.Tensor:
    """Body: X with the outlier columns shifted down by 2^e (Eq. 4)."""
    return torch.where(_as_mask(mask, x), x * 2.0 ** (-exp_factor), x).to(x.dtype)


def reconstruct(body: torch.Tensor, mask, exp_factor: int) -> torch.Tensor:
    """Eq. 6: X = Body + (2^e - 1) * Aux, the exact inverse of decompose."""
    aux = torch.where(_as_mask(mask, body), body, torch.zeros_like(body))
    return (body + (2.0 ** exp_factor - 1.0) * aux).to(body.dtype)


def _resolve_mask(x: torch.Tensor, cfg: QuantConfig, mask) -> torch.Tensor:
    if mask is not None:
        return _as_mask(mask, x)
    return O.outlier_mask(x, cfg.outlier_threshold)


# ---------------------------------------------------------------------------
# Fake-quant path (quantize -> dequantize -> compute)
# ---------------------------------------------------------------------------

def muxq_fake_quant_act(x: torch.Tensor, cfg: QuantConfig, mask=None) -> torch.Tensor:
    """Fake-quantized activation under MUXQ.

    paper form : Body and Aux quantized with independent scales:
                 X' = qdq(Body) + (2^e-1) * qdq(Aux)
    fused form : one quantization of Body; outlier columns times 2^e:
                 X' = qdq(Body) * (2^e on M, 1 off M)
    """
    mask = _resolve_mask(x, cfg, mask)
    body = decompose(x, mask, cfg.exp_factor)
    if cfg.muxq_form == "fused":
        bq = Q.fake_quant(body, cfg.act_bits, cfg.act_granularity)
        return reconstruct(bq, mask, cfg.exp_factor)
    zero = torch.zeros_like(x)
    aux = torch.where(mask, body, zero)
    bq = Q.fake_quant(body, cfg.act_bits, cfg.act_granularity)
    # Aux's abs-max sees only the outlier columns it represents
    aq = Q.fake_quant(aux, cfg.act_bits, cfg.act_granularity)
    aq = torch.where(mask, aq, zero)
    return (bq + (2.0 ** cfg.exp_factor - 1.0) * aq).to(x.dtype)


# ---------------------------------------------------------------------------
# Real INT8 path (uniform-precision GEMMs)
# ---------------------------------------------------------------------------

def muxq_matmul_paper(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig,
                      mask=None) -> torch.Tensor:
    """The faithful two-GEMM INT8 execution (Eq. 7): Body and Aux on
    Body's integer grid (shared scale), two int GEMMs, no fp side path."""
    mask = _resolve_mask(x, cfg, mask)
    body = decompose(x, mask, cfg.exp_factor)
    aux = torch.where(mask, body, torch.zeros_like(body))
    wi, sw = Q.quantize(w, cfg.weight_bits, cfg.weight_granularity)
    bi, sb = Q.quantize(body, cfg.act_bits, cfg.act_granularity)
    ai, _ = Q.quantize(aux, cfg.act_bits, cfg.act_granularity, scale=sb)
    y_body = Q.int_matmul(bi, wi).float() * sb * sw
    y_aux = Q.int_matmul(ai, wi).float() * sb * sw
    return (y_body + (2.0 ** cfg.exp_factor - 1.0) * y_aux).to(x.dtype)


def muxq_int32(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig, mask=None):
    """The fused form's integer stage: (Body codes, their scale, weight
    codes, weight scale, int32 accumulator (B_int * (2^e on M)) @ W_int)."""
    mask = _resolve_mask(x, cfg, mask)
    body = decompose(x, mask, cfg.exp_factor)
    bi, sb = Q.quantize(body, cfg.act_bits, cfg.act_granularity)
    wi, sw = Q.quantize(w, cfg.weight_bits, cfg.weight_granularity)
    mult = torch.where(mask, 2 ** cfg.exp_factor, 1).to(torch.int32)
    return bi, sb, wi, sw, Q.int_matmul(bi.to(torch.int32) * mult, wi)


def muxq_matmul_fused(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig,
                      mask=None) -> torch.Tensor:
    """The fused form: ONE int GEMM, the outlier rows' int32 contribution
    scaled by 2^e (exact).  Here the multiplier rides on the int32-widened
    operand; the packed kernel applies it per K-block in its accumulator."""
    _, sb, _, sw, yi = muxq_int32(x, w, cfg, mask)
    return (yi.float() * sb * sw).to(x.dtype)


# ---------------------------------------------------------------------------
# Unified matmul dispatch
# ---------------------------------------------------------------------------

def qmatmul(x: torch.Tensor, w: torch.Tensor, cfg: QuantConfig, mask=None,
            smooth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Policy-dispatched matmul.  ``mask``: static calibrated outlier mask
    [in_features]; ``smooth``: the calibrated activation abs-max the
    SmoothQuant factors derive from (None: the live abs-max)."""
    from repro_torch.core import llm_int8 as L8
    from repro_torch.core import smoothquant as SQ

    if cfg.method == "fp":
        return x @ w
    if cfg.method in SMOOTH_METHODS:
        x, w = SQ.apply_smoothing(x, w, smooth, alpha=cfg.smooth_alpha)
        # a static mask calibrated before smoothing names the same channels
        cfg = cfg.replace(method="naive" if cfg.method == "smoothquant" else "muxq")

    if cfg.method == "naive":
        if cfg.real_int8:
            return Q.quantized_matmul(x, w, cfg.act_bits, cfg.weight_bits,
                                      cfg.act_granularity, cfg.weight_granularity)
        xq = Q.fake_quant(x, cfg.act_bits, cfg.act_granularity)
        wq = Q.fake_quant(w, cfg.weight_bits, cfg.weight_granularity)
        return xq @ wq

    if cfg.method == "muxq":
        if cfg.outlier_mode == "dynamic":
            mask = None         # live detection
        if cfg.real_int8:
            fn = muxq_matmul_fused if cfg.muxq_form == "fused" else muxq_matmul_paper
            return fn(x, w, cfg, mask)
        xq = muxq_fake_quant_act(x, cfg, mask)
        wq = Q.fake_quant(w, cfg.weight_bits, cfg.weight_granularity)
        return xq @ wq

    if cfg.method == "llm_int8":
        if cfg.outlier_mode == "dynamic":
            mask = None
        return L8.llm_int8_matmul(x, w, cfg, mask)

    raise ValueError(f"unknown method {cfg.method}")
