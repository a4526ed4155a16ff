"""Outlier-channel detection and calibration statistics (counterpart of
``repro/core/outliers.py``).

A channel is an outlier iff some activation has |x| > threshold (6.0 by
default, the LLM.int8() criterion the paper adopts, §3.3).  Two modes:
  * dynamic — the mask comes from the live activation (:func:`outlier_mask`);
  * static  — the mask is calibrated offline over sample batches and
              frozen (:class:`ChannelStats` / :class:`CalibrationStats`).
Statistics accumulate on the host in numpy, as in the reference, so the
calibrated masks are the same arrays and ``save`` writes the same npz.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

DEFAULT_THRESHOLD = 6.0


def outlier_mask(x: torch.Tensor, threshold: float = DEFAULT_THRESHOLD) -> torch.Tensor:
    """Bool mask over the channel (last) axis: True where the channel holds
    any element with |x| > threshold."""
    return (torch.abs(x) > threshold).reshape(-1, x.shape[-1]).any(dim=0)


def channel_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per-channel abs-max over all leading axes."""
    return torch.abs(x).reshape(-1, x.shape[-1]).amax(dim=0)


def topk_outlier_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mask selecting the k channels with the largest abs-max (every channel
    tied with the k-th largest included, as in the reference)."""
    amax = channel_absmax(x)
    if k <= 0:
        return torch.zeros_like(amax, dtype=torch.bool)
    return amax >= torch.sort(amax).values[-k]


@dataclasses.dataclass
class ChannelStats:
    """Running per-channel statistics for one quantized matmul site."""
    absmax: np.ndarray   # [channels]
    absmean: np.ndarray  # [channels] running mean of |x| (SmoothQuant)
    count: int = 0

    @classmethod
    def empty(cls, channels: int) -> "ChannelStats":
        return cls(absmax=np.zeros(channels, np.float32),
                   absmean=np.zeros(channels, np.float32), count=0)

    def update(self, x) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        x2 = np.asarray(x, np.float32).reshape(-1, x.shape[-1])
        self.absmax = np.maximum(self.absmax, np.abs(x2).max(axis=0))
        n_new = x2.shape[0]
        mean_new = np.abs(x2).mean(axis=0)
        total = self.count + n_new
        self.absmean = (self.absmean * self.count + mean_new * n_new) / max(total, 1)
        self.count = total

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
    """Dict of site name -> ChannelStats, filled by a CollectCtx pass;
    saved to and loaded from npz in the reference's key format
    (``{site}::absmax``, ``::absmean``, ``::count``)."""

    def __init__(self) -> None:
        self.sites: Dict[str, ChannelStats] = {}

    def update(self, name: str, x) -> None:
        if name not in self.sites:
            self.sites[name] = ChannelStats.empty(int(x.shape[-1]))
        self.sites[name].update(x)

    def masks(self, threshold: float = DEFAULT_THRESHOLD) -> Dict[str, np.ndarray]:
        return {k: v.mask(threshold) for k, v in self.sites.items()}

    def save(self, path) -> None:
        flat = {}
        for k, v in self.sites.items():
            flat[f"{k}::absmax"] = v.absmax
            flat[f"{k}::absmean"] = v.absmean
            flat[f"{k}::count"] = np.asarray(v.count)
        np.savez(path, **flat)

    @classmethod
    def load(cls, path) -> "CalibrationStats":
        out = cls()
        with np.load(path) as data:
            for name in sorted({k.split("::")[0] for k in data.files}):
                out.sites[name] = ChannelStats(
                    absmax=data[f"{name}::absmax"],
                    absmean=data[f"{name}::absmean"],
                    count=int(data[f"{name}::count"]))
        return out
