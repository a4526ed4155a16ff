"""Paged attention over block-sparse KV pages: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/paged_attention.py``.  The query side is a
``[slot, sq]`` block: decode (sq = 1, ``pos[b]`` the slot's write
position) and chunked prefill (sq = C, ``pos`` the chunk's first
position); query row i of slot b sits at absolute position ``pos[b] + i``.
Pages are fp (the pool dtype) or int8 with per-(position, head) f32
scales.  The int4 nibble mode of the reference is a later slice and is
refused here.

Execution (mirrors ``set_fused_impl``): ``auto`` launches the CUDA kernel
for CUDA tensors and takes the plain version for CPU tensors; ``ref``
forces the plain version.  A CUDA tensor never falls back silently.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e9          # matches models/attention.NEG_INF (parity)
NO_WINDOW = 1 << 30     # "sliding window off" sentinel (int32-safe)

PagedImpl = Literal["auto", "ref"]

_PAGED_IMPL: PagedImpl = "auto"

LAUNCHES = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def set_paged_impl(impl: PagedImpl) -> PagedImpl:
    """Select how paged attention executes; returns the previous setting."""
    global _PAGED_IMPL
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown paged impl {impl!r}")
    prev, _PAGED_IMPL = _PAGED_IMPL, impl
    return prev


# ---------------------------------------------------------------------------
# Plain version (the reference's gather-then-attend math)
# ---------------------------------------------------------------------------

def paged_attention_plain(q, k_pages, v_pages, page_table, pos, *,
                          k_scale=None, v_scale=None, window=None,
                          softcap: Optional[float] = None):
    """Gather-then-attend, the op sequence of the reference's
    ``paged_attention_ref``.  q [b, h, dh] or [b, sq, h, dh]; pages
    [n_pages, ps, kvh, dh] (+ optional int8 scales [n_pages, ps, kvh, 1]);
    page_table [b, P] int32; pos [b] int32.  Returns q's shape."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, h, dh = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    table = page_table.long()

    def gather(pages):
        gp = pages[table]                             # [b, P, ps, kvh, *]
        return gp.reshape(b, -1, *gp.shape[3:])

    kk, vv = gather(k_pages), gather(v_pages)
    if k_scale is not None:
        kk = (kk.float() * gather(k_scale)).to(q.dtype)
        vv = (vv.float() * gather(v_scale)).to(q.dtype)
    else:
        kk = kk.to(q.dtype)
        vv = vv.to(q.dtype)

    window = NO_WINDOW if window is None else int(window)
    kpos = torch.arange(kk.shape[1], device=q.device)[None, None, :]
    qpos = (pos.long()[:, None, None]
            + torch.arange(sq, device=q.device)[None, :, None])
    allow = (kpos <= qpos) & (kpos > qpos - window)
    bias = torch.where(allow, 0.0, NEG_INF).float()[:, None, None]

    qg = q.reshape(b, sq, kvh, g, dh)
    scale = dh ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kk).float() * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vv).reshape(b, sq, h, dh)
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale, window,
            softcap):
    global LAUNCHES
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, h, dh = q.shape
    n_pages, ps, kvh, pk_dh = k_pages.shape
    if h % kvh or pk_dh != dh or ps > 32:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} (page size <= 32)")
    if q.dtype not in _Q_CODES or k_pages.dtype not in _KV_CODES:
        raise ValueError(f"unsupported dtypes q {q.dtype}, pages {k_pages.dtype}")
    int8 = k_pages.dtype == torch.int8
    if int8 != (k_scale is not None):
        raise ValueError("int8 pages need f32 scales; fp pages take none")
    tensors = [k_pages, v_pages, page_table, pos] + (
        [k_scale, v_scale] if int8 else [])
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous and "
                             "on q's device")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_table and pos must be int32")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise ValueError("int8 page scales must be f32")
    q = q.contiguous()
    out = torch.empty_like(q)
    rc = build.launcher("paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if int8 else None,
            v_scale.data_ptr() if int8 else None,
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, sq, h, kvh, dh, ps, page_table.shape[1],
            NO_WINDOW if window is None else int(window),
            dh ** -0.5, 0.0 if softcap is None else float(softcap),
            _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    LAUNCHES += 1
    return out[:, 0] if squeeze else out


def paged_attention_decode(q, k_pages, v_pages, page_table, pos, *,
                           k_scale=None, v_scale=None, k_redist=None,
                           v_redist=None, window=None,
                           softcap: Optional[float] = None):
    """Impl-dispatching entry point.  q [b, h, dh] (decode) or
    [b, sq, h, dh] (prefill chunk, ``pos`` the first row's position)."""
    if k_redist is not None or v_redist is not None:
        raise NotImplementedError("int4 KV pages are not ported yet")
    if _PAGED_IMPL == "ref" or not q.is_cuda:
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos,
                                     k_scale=k_scale, v_scale=v_scale,
                                     window=window, softcap=softcap)
    return _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                   window, softcap)
