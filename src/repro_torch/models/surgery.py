"""Function-preserving outlier injection — counterpart of
``repro/models/surgery.py``.

A briefly trained small model may have no activation channel outliers.
To evaluate outlier handling faithfully, transplant the phenomenon: scale
chosen channels of both pre-matmul norm gains by gamma and divide the
matching rows of the consuming weights (``wqkv``, the MLP's ``wi``) by
gamma.  In exact arithmetic the network function is unchanged; the
activation entering each quantized matmul now has genuine channel
outliers of magnitude ~gamma x normal.  RMSNorm stores its gain as an
offset from 1, so the scaled gain is ``(1 + g) * gamma - 1``.  The
input params are left untouched.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.models.common import ModelConfig


def inject_outliers(cfg: ModelConfig, params, channels: Sequence[int],
                    gamma: float = 20.0) -> dict:
    """New params with the gains of ``ln1``/``ln2`` scaled up on
    ``channels`` in every layer and the rows of ``attn/wqkv`` and
    ``mlp/wi`` scaled down to match; ``params`` is left untouched."""
    if cfg.family != "dense":
        raise ValueError("outlier surgery targets the paper's dense family, "
                         f"not {cfg.family}")
    layers = params["layers"]
    ch = torch.as_tensor(np.asarray(list(channels), np.int64),
                         device=layers[0]["ln1"]["gain"].device)
    g = torch.full((), gamma, dtype=torch.float32, device=ch.device)

    def scale_gain(gain):
        # the reference's op order: the whole offset gain goes through
        # 1 + g and back, which rounds the channels left alone too
        out = 1.0 + gain if cfg.norm == "rmsnorm" else gain.clone()
        out[ch] = out[ch] * g
        return out - 1.0 if cfg.norm == "rmsnorm" else out

    def divide_rows(w):
        out = w.clone()
        out[ch] = w[ch] / g
        return out

    new_layers = []
    for lp in layers:
        lp = dict(lp)
        for ln in ("ln1", "ln2"):
            lp[ln] = {**lp[ln], "gain": scale_gain(lp[ln]["gain"])}
        lp["attn"] = {**lp["attn"], "wqkv": divide_rows(lp["attn"]["wqkv"])}
        lp["mlp"] = {**lp["mlp"], "wi": divide_rows(lp["mlp"]["wi"])}
        new_layers.append(lp)
    return {**params, "layers": new_layers}


def pick_outlier_channels(cfg: ModelConfig, n: int = 6, seed: int = 0) -> np.ndarray:
    """``n`` distinct channels of ``d_model``, drawn from ``seed`` as the
    reference draws them."""
    rng = np.random.default_rng(seed)
    return rng.choice(cfg.d_model, size=n, replace=False)
