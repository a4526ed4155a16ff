"""Dense MLP blocks (SwiGLU / GELU), every projection through the
quantization ctx — counterpart of ``repro/models/mlp.py``.  GELU is the
tanh approximation, as ``jax.nn.gelu`` computes by default."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Seeded weights of one MLP block, the reference's shapes and scales."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wi": dense_init(gen, (d, 2 * f), d, device),
                "wo": dense_init(gen, (f, d), f, device)}
    return {"wi": dense_init(gen, (d, f), d, device),
            "wo": dense_init(gen, (f, d), f, device),
            "bi": torch.zeros(f, device=device),
            "bo": torch.zeros(d, device=device)}


def mlp(cfg: ModelConfig, p: dict, ctx, x: torch.Tensor) -> torch.Tensor:
    h = ctx("mlp_up", x, p["wi"])
    if cfg.mlp_type == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        if "bi" in p:
            h = h + p["bi"].to(x.dtype)
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    out = ctx("mlp_down", h, p["wo"])
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out
