"""Outlier-channel calibration statistics (counterpart of the static-mode
part of ``repro/core/outliers.py``).

A channel is an outlier iff some calibration activation has
|x| > threshold (6.0 by default, the LLM.int8() criterion the paper
adopts, §3.3).  Statistics accumulate on the host in numpy, as in the
reference, so the calibrated masks are the same arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

DEFAULT_THRESHOLD = 6.0


@dataclasses.dataclass
class ChannelStats:
    """Running per-channel |x| maximum for one quantized matmul site (the
    reference also keeps the |x| mean for SmoothQuant, which the port does
    not calibrate yet)."""
    absmax: np.ndarray   # [channels]
    count: int = 0

    @classmethod
    def empty(cls, channels: int) -> "ChannelStats":
        return cls(absmax=np.zeros(channels, np.float32), count=0)

    def update(self, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        x2 = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
        self.absmax = np.maximum(self.absmax, np.abs(x2).max(axis=0))
        self.count += x2.shape[0]

    def mask(self, threshold: float = DEFAULT_THRESHOLD,
             max_frac: float = 0.25) -> np.ndarray:
        """Calibrated static outlier mask, capped at ``max_frac`` of the
        channels (the top channels by abs-max beyond the cap)."""
        m = self.absmax > threshold
        k_cap = max(1, int(max_frac * len(self.absmax)))
        if m.sum() > k_cap:
            order = np.argsort(-self.absmax)
            m = np.zeros_like(m)
            m[order[:k_cap]] = True
        return m


class CalibrationStats:
    """Dict of site name -> ChannelStats, filled by a CollectCtx pass."""

    def __init__(self) -> None:
        self.sites: Dict[str, ChannelStats] = {}

    def update(self, name: str, x) -> None:
        if name not in self.sites:
            self.sites[name] = ChannelStats.empty(int(x.shape[-1]))
        self.sites[name].update(x)

    def masks(self, threshold: float = DEFAULT_THRESHOLD) -> Dict[str, np.ndarray]:
        return {k: v.mask(threshold) for k, v in self.sites.items()}
