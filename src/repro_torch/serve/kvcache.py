"""KV-cache utilities — counterpart of ``repro/serve/kvcache.py``: INT8
KV quantization (Oaken-style per-(position, head) scales over
``head_dim``), its inverse, the dense int8 cache and its byte count."""
from __future__ import annotations

from typing import Dict, Tuple

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


def dequantize_kv(cache: Dict[str, torch.Tensor], dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 K/V and their scales -> K, V in ``dtype``."""
    k = (cache["k"].float() * cache["k_scale"]).to(dtype)
    v = (cache["v"].float() * cache["v_scale"]).to(dtype)
    return k, v


def init_int8_cache(cfg, batch: int, s_max: int, device="cuda") -> dict:
    """Zero dense int8 KV cache: k/v [L, b, s_max, kvh, dh] int8,
    k/v_scale [L, b, s_max, kvh, 1] f32, ``pos`` 0 (0-d int32)."""
    # imported here: attention imports serve.kvq, which imports this module
    from repro_torch.models.attention import n_attn_layers

    shape = (n_attn_layers(cfg), batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    sshape = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def cache_bytes(cache) -> int:
    """Buffer bytes of the cache's arrays (0-d bookkeeping such as ``pos``
    left out), so packed layouts report their physical footprint."""
    return sum(t.numel() * t.element_size() for t in cache.values()
               if isinstance(t, torch.Tensor) and t.dim() > 0)
