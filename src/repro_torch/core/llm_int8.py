"""LLM.int8() mixed-precision decomposition baseline (Dettmers et al. 2022),
counterpart of ``repro/core/llm_int8.py``.

Outlier columns of X (and the matching rows of W) are computed in full
precision; everything else goes through the INT8 path.  This is the
mixed-precision scheme whose fp side path MUXQ removes.  Mask-based, as
in the reference: the fp "gather" is a masked dense matmul.
"""
from __future__ import annotations

import torch

from repro_torch.core import outliers as O
from repro_torch.core import quantizers as Q


def llm_int8_matmul(x: torch.Tensor, w: torch.Tensor, cfg, mask=None) -> torch.Tensor:
    """Y = X_out @ W (full precision) + dequant(X_norm_int @ W_int)."""
    if mask is None:
        mask = O.outlier_mask(x, cfg.outlier_threshold)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=x.device)
    zero = torch.zeros_like(x)
    x_norm = torch.where(mask, zero, x)
    x_out = torch.where(mask, x, zero)
    y_fp = x_out @ w
    if cfg.real_int8:
        y_int = Q.quantized_matmul(x_norm, w, cfg.act_bits, cfg.weight_bits,
                                   cfg.act_granularity, cfg.weight_granularity)
    else:
        xq = Q.fake_quant(x_norm, cfg.act_bits, cfg.act_granularity)
        xq = torch.where(mask, zero, xq)    # masked columns stay exactly 0
        wq = Q.fake_quant(w, cfg.weight_bits, cfg.weight_granularity)
        y_int = xq @ wq
    return (y_fp + y_int).to(x.dtype)
