"""INT8 KV quantization (Oaken-style per-(position, head) scales over
``head_dim``) — counterpart of ``quantize_kv`` in
``repro/serve/kvcache.py``."""
from __future__ import annotations

from typing import Dict

import torch


def quantize_kv(k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[..., kv, dh] -> int8 codes + f32 scales [..., kv, 1]."""
    def q(x):
        xf = x.float()
        amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-6)
        # divide by a tensor: PyTorch's CUDA division by a host scalar
        # multiplies by its reciprocal, not the reference's IEEE quotient
        s = amax / torch.full((), 127.0, device=amax.device)
        xi = torch.clamp(torch.round(xf / s), -127, 127)
        return xi.to(torch.int8), s

    ki, ks = q(k)
    vi, vs = q(v)
    return {"k": ki, "k_scale": ks, "v": vi, "v_scale": vs}
