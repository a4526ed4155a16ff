"""Paged attention over block-sparse KV pages: the hand-written CUDA kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/paged_attention.py``.  The query side is a
``[slot, sq]`` block: decode (sq = 1, ``pos[b]`` the slot's write
position), speculative verify (sq = k draft rows per slot) and chunked
prefill (sq = C, ``pos`` the chunk's first position); query row i of
slot b sits at absolute position ``pos[b] + i``.  Pages are fp (the pool dtype), int8
with per-(position, head) f32 scales, or int4: nibble-packed
``[..., dh/2]`` int8 bytes with bf16 scales and per-head ``[kvh, dh]`` f32
redistribution rows (2^e on the calibrated outlier channels).

Execution (mirrors ``set_fused_impl``): ``auto`` launches the CUDA kernel
for CUDA tensors and takes the plain version for CPU tensors; ``ref``
forces the plain version.  A CUDA tensor never falls back silently.
``MODE_LAUNCHES`` counts kernel launches by page mode (their sum is the
kernel's launch count).
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.kernels import build
from repro_torch.serve.kvq import unpack_int4

NEG_INF = -1e9          # matches models/attention.NEG_INF (parity)
NO_WINDOW = 1 << 30     # "sliding window off" sentinel (int32-safe)

PagedImpl = Literal["auto", "ref"]

_PAGED_IMPL: PagedImpl = "auto"

MODE_LAUNCHES = {"fp": 0, "int8": 0, "int4": 0}

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KV_INT4 = 3            # int8 storage holding two int4 codes per byte


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
                          k_scale=None, v_scale=None, k_redist=None,
                          v_redist=None, window=None,
                          softcap: Optional[float] = None):
    """Gather-then-attend, the op sequence of the reference's
    ``paged_attention_ref``.  q [b, h, dh] or [b, sq, h, dh]; pages
    [n_pages, ps, kvh, dh] (+ optional int8 scales [n_pages, ps, kvh, 1];
    int4 pages are [n_pages, ps, kvh, dh//2] packed bytes with bf16 scales
    and [kvh, dh] ``k_redist``/``v_redist`` rows); page_table [b, P] int32;
    pos [b] int32.  Returns q's shape."""
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
    if k_redist is not None:
        # int4: unpack nibbles, scale, undo the MUXQ magnitude shift
        kk = (unpack_int4(kk).float() * gather(k_scale).float()
              * k_redist).to(q.dtype)
        vv = (unpack_int4(vv).float() * gather(v_scale).float()
              * v_redist).to(q.dtype)
    elif k_scale is not None:
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

def _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
            k_redist, v_redist, window, softcap):
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, h, dh = q.shape
    n_pages, ps, kvh, pk_dh = k_pages.shape
    int4 = k_redist is not None
    if h % kvh or pk_dh != (dh // 2 if int4 else dh) or ps > 32 or dh % 2:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} (page size <= 32; int4 "
                         "pages hold dh/2 packed bytes)")
    if q.dtype not in _Q_CODES or k_pages.dtype not in _KV_CODES:
        raise ValueError(f"unsupported dtypes q {q.dtype}, pages {k_pages.dtype}")
    scaled = k_pages.dtype == torch.int8
    if scaled != (k_scale is not None) or (v_redist is not None) != int4 \
            or (int4 and not scaled):
        raise ValueError("int8 pages need f32 scales, int4 pages bf16 scales "
                         "and both redist rows; fp pages take none")
    scale_dt = torch.bfloat16 if int4 else torch.float32
    if scaled and (k_scale.dtype != scale_dt or v_scale.dtype != scale_dt
                   or k_scale.shape != (n_pages, ps, kvh, 1)
                   or v_scale.shape != k_scale.shape):
        raise ValueError(f"{'int4' if int4 else 'int8'} page scales must be "
                         f"{scale_dt} [n_pages, ps, kvh, 1]")
    if int4 and any(r.dtype != torch.float32 or r.shape != (kvh, dh)
                    for r in (k_redist, v_redist)):
        raise ValueError("int4 redist rows must be f32 [kvh, dh]")
    tensors = [k_pages, v_pages, page_table, pos] + (
        [k_scale, v_scale] if scaled else []) + (
        [k_redist, v_redist] if int4 else [])
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged attention operands must be contiguous and "
                             "on q's device")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("page_table and pos must be int32")
    q = q.contiguous()
    out = torch.empty_like(q)
    rc = build.launcher("paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if scaled else None,
            v_scale.data_ptr() if scaled else None,
            k_redist.data_ptr() if int4 else None,
            v_redist.data_ptr() if int4 else None,
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, sq, h, kvh, dh, ps, page_table.shape[1],
            NO_WINDOW if window is None else int(window),
            dh ** -0.5, 0.0 if softcap is None else float(softcap),
            _Q_CODES[q.dtype], _KV_INT4 if int4 else _KV_CODES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    MODE_LAUNCHES["int4" if int4 else "int8" if scaled else "fp"] += 1
    return out[:, 0] if squeeze else out


def paged_attention_decode(q, k_pages, v_pages, page_table, pos, *,
                           k_scale=None, v_scale=None, k_redist=None,
                           v_redist=None, window=None,
                           softcap: Optional[float] = None):
    """Impl-dispatching entry point.  q [b, h, dh] (decode) or
    [b, sq, h, dh] (verify block / prefill chunk, ``pos`` the first row's
    position)."""
    if _PAGED_IMPL == "ref" or not q.is_cuda:
        return paged_attention_plain(q, k_pages, v_pages, page_table, pos,
                                     k_scale=k_scale, v_scale=v_scale,
                                     k_redist=k_redist, v_redist=v_redist,
                                     window=window, softcap=softcap)
    return _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                   k_redist, v_redist, window, softcap)
