"""Offline calibration runner — counterpart of ``repro/core/calibrate.py``.

Runs the model eagerly over a handful of sample batches with a
``CollectCtx``, then derives the per-site outlier masks (|x| > threshold,
paper §3.3) and per-site activation abs-max vectors.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.core.context import CollectCtx
from repro_torch.core.outliers import CalibrationStats, DEFAULT_THRESHOLD


def calibrate(forward: Callable, params, batches: Iterable,
              threshold: float = DEFAULT_THRESHOLD,
              ) -> Tuple[CalibrationStats, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """``forward(params, batch, ctx=...)`` is invoked eagerly per batch,
    without autograd.  Returns (raw stats, outlier masks, per-site
    activation abs-max)."""
    ctx = CollectCtx()
    with torch.no_grad():
        for batch in batches:
            forward(params, batch, ctx=ctx)
    masks = ctx.stats.masks(threshold)
    absmax = {k: v.absmax for k, v in ctx.stats.sites.items()}
    return ctx.stats, masks, absmax
