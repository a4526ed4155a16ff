"""Dense flash-attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py``: causal, GQA (query
head h reads KV head ``h // (H / KV)``), optional sliding window and
softcap, masked scores at ``NEG_INF = -1e30``, f32 accumulation.  Layouts
are the reference's: q [b, sq, h, dh], k/v [b, sk, kv, dh], f32 or bf16;
the output has q's shape and dtype.

No model path of the port calls it (the reference's dense ``attention``
runs ``sdpa``, and serving reads paged KV); ``chip_smoke.py`` holds the
kernel against the plain version on the card.

Execution: CUDA tensors launch the kernel, CPU tensors take the plain
version; a CUDA tensor never falls back.  ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

LAUNCHES = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention with GQA broadcast, in f32 — the op
    sequence of the reference's ``flash_attention_ref``."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (dh ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    allow = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        allow = allow & (kpos <= qpos)
    if window is not None:
        allow = allow & (kpos > qpos - window)
    s = torch.where(allow[None, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def _launch(q, k, v, causal, window, softcap):
    global LAUNCHES
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, dh) or v.shape != k.shape or dh > 256:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (head_dim <= 256)")
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"unsupported dtypes q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype} (f32 or bf16, all alike)")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("flash attention operands must be on q's device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    queue = torch.empty(1, dtype=torch.int32, device=q.device)
    rc = build.launcher("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        queue.data_ptr(), b, sq, sk, h, kv, dh, int(causal),
        0 if window is None else int(window),
        dh ** -0.5, 0.0 if softcap is None else float(softcap),
        _CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    LAUNCHES += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [b, sq, h, dh], k/v [b, sk, kv, dh] (kv | h) -> [b, sq, h, dh]."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} are not a multiple of "
                         f"KV heads {k.shape[2]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return _launch(q, k, v, causal, window, softcap)
