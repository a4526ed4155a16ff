"""SmoothQuant difficulty migration (Xiao et al. 2023), counterpart of
``repro/core/smoothquant.py``: a baseline, and composed with MUXQ
(``muxq_smooth``).

Per input channel j:  s_j = max|X_j|^alpha / max|W_j|^(1-alpha);
X' = X / s and W' = s * W (exact in real arithmetic), X' flatter per
channel.  ``act_absmax`` is the calibrated per-channel activation
abs-max; without one, the live activation's.

The two powers run in float64 and round once to f32: the correctly
rounded f32 power, the same on every device.  (PyTorch's f32 ``pow`` on
the CPU is vectorized and sits an ulp off it for about 0.7 % of inputs;
XLA's f32 ``power``, the reference's, for about 0.07 %.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-5


def _pow(x: torch.Tensor, e: float) -> torch.Tensor:
    return (x.double() ** e).float()


def smoothing_factors(act_absmax: torch.Tensor, w: torch.Tensor,
                      alpha: float = 0.5) -> torch.Tensor:
    """Per-input-channel divisors s [in_ch] from the activation abs-max and
    the weight's per-row abs-max (f32 throughout)."""
    w_absmax = torch.abs(w).reshape(w.shape[0], -1).amax(dim=1)
    a = torch.clamp_min(torch.as_tensor(act_absmax, device=w.device).float(), _EPS)
    b = torch.clamp_min(w_absmax.float(), _EPS)
    return torch.clamp_min(_pow(a, alpha) / _pow(b, 1.0 - alpha), _EPS)


def apply_smoothing(x: torch.Tensor, w: torch.Tensor,
                    act_absmax: Optional[torch.Tensor],
                    alpha: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X / s, s * W)."""
    if act_absmax is None:
        act_absmax = torch.abs(x).reshape(-1, x.shape[-1]).amax(dim=0)
    s = smoothing_factors(act_absmax, w, alpha)
    x_s = (x / s).to(x.dtype)
    w_s = (w * s[:, None] if w.ndim == 2 else w * s).to(w.dtype)
    return x_s, w_s
