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
kernel's launch count), ``TILE_LAUNCHES`` by the tile that ran;
``accounting`` sees every call.

The kernel's grid is (KV split, row tile, slot x KV head): ``plan_splits``
cuts a slot's ``sq * g`` query rows into tiles of ``ROW_TILE`` and its page
table into splits, from the table's width alone (``pos`` stays on the
card).  Two tiles of ``ROW_TILE`` rows run a block, ``chunk_tile`` picks
one from the shape: the row tile serves decode, verify, bf16 q and dh 256;
f32 q with more than one row tile of rows (a prefill chunk) at dh <= 128
takes the register-blocked chunk tile, whose output is the row tile's bit
for bit.  With several splits the C call launches a second, merging pass
over f32 partials in scratch that the wrapper allocates.  Under
tensor-parallel serving a rank's pages hold only its KV heads; the caller
passes the model's global KV-head count as ``plan_kv_heads``, so the plan
(and with it every (slot, head) block's order of sums) is the one the
whole model gets on one device.
"""
from __future__ import annotations

import math
from typing import Literal, Optional, Tuple

import torch

from repro_torch.kernels import accounting, build
from repro_torch.serve.kvq import unpack_int4

NEG_INF = -1e9          # matches models/attention.NEG_INF (parity)
NO_WINDOW = 1 << 30     # "sliding window off" sentinel (int32-safe)

PagedImpl = Literal["auto", "ref"]

_PAGED_IMPL: PagedImpl = "auto"

MODE_LAUNCHES = {"fp": 0, "int8": 0, "int4": 0}
TILE_LAUNCHES = {"row": 0, "chunk": 0}

ROW_TILE = 64           # query rows of a block (4 warps x 16; csrc attn::kRows)
MAX_PAGES_PER_SPLIT = 1024   # a split's page ids sit in shared memory
MAX_HEAD_DIM = 256

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

def key_tile(dh: int) -> int:
    """Keys of the kernel's K/V tile at head dim dh (csrc key_tile): 64 up
    to dh 64, 32 up to 128, 16 up to 256."""
    return 4096 // (64 if dh <= 64 else 128 if dh <= 128 else 256)


def chunk_tile(rows: int, dh: int, f32: bool) -> bool:
    """Does a launch of ``rows = sq * g`` query rows per (slot, KV head)
    take the chunk tile?  f32 q with more rows than one row tile (a
    prefill chunk) at dh <= 128, a multiple of 8 (its dequantization reads
    four channels at once); decode, verify, bf16 q (its tensor-core path)
    and dh 224 or 256 keep the row tile."""
    return f32 and rows > ROW_TILE and dh <= 128 and dh % 8 == 0


def plan_splits(b: int, kvh: int, rows: int, n_table: int, ps: int, dh: int,
                n_sm: int = 132) -> Tuple[int, int, int]:
    """The kernel's grid for ``rows = sq * g`` query rows per (slot, KV
    head) over a page table ``n_table`` pages of ``ps`` wide:
    ``(n_row_tiles, pages_per_split, n_split)``.  A table that fits one
    key tile is not split: a block's time is mostly fixed latency, so
    splitting one tile adds blocks and a merge pass and saves nothing (and
    the unsplit tile matches the plain version's arithmetic).  A longer
    table is split until the grid fills one wave of ``n_sm`` blocks
    (decode on few slots and heads), never finer than one page a split; a
    split holds at most ``MAX_PAGES_PER_SPLIT`` pages.  Split s covers
    pages ``[s * pps, min((s + 1) * pps, n_table))``; none is empty."""
    n_rt = -(-rows // ROW_TILE)
    if n_table * ps <= key_tile(dh):
        return n_rt, max(1, n_table), 1
    want = min(n_table, max(1, -(-n_sm // (b * kvh * n_rt))))
    pps = min(-(-n_table // want), MAX_PAGES_PER_SPLIT)
    return n_rt, pps, -(-n_table // pps)


def workspace_floats(b: int, kvh: int, rows: int, dh: int, n_row_tiles: int,
                     n_split: int) -> int:
    """f32 scratch of the split partials: O, m and l of every split's rows
    (none with a single split)."""
    if n_split == 1:
        return 0
    return n_split * b * kvh * n_row_tiles * ROW_TILE * (dh + 2)


def _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
            k_redist, v_redist, window, softcap, plan_kv_heads=None):
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, sq, h, dh = q.shape
    n_pages, ps, kvh, pk_dh = k_pages.shape
    int4 = k_redist is not None
    if h % kvh or pk_dh != (dh // 2 if int4 else dh) or ps > 32 or dh % 2 \
            or dh > MAX_HEAD_DIM:
        raise ValueError(f"bad shapes: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)} (page size <= 32, even "
                         f"head_dim <= {MAX_HEAD_DIM}; int4 pages hold dh/2 "
                         "packed bytes)")
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
    n_table = page_table.shape[1]
    rows = sq * (h // kvh)
    chunk = chunk_tile(rows, dh, q.dtype == torch.float32)
    n_rt, pps, n_split = plan_splits(b, plan_kv_heads or kvh, rows, n_table, ps,
                                     dh, build.sm_count(q.device))
    ws = None if n_split == 1 else torch.empty(
        workspace_floats(b, kvh, rows, dh, n_rt, n_split),
        dtype=torch.float32, device=q.device)
    rc = build.launcher("paged_attention")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if scaled else None,
            v_scale.data_ptr() if scaled else None,
            k_redist.data_ptr() if int4 else None,
            v_redist.data_ptr() if int4 else None,
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, sq, h, kvh, dh, ps, n_table,
            NO_WINDOW if window is None else int(window), pps, n_split, int(chunk),
            dh ** -0.5, 0.0 if softcap is None else float(softcap),
            _Q_CODES[q.dtype], _KV_INT4 if int4 else _KV_CODES[k_pages.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_attention")
    MODE_LAUNCHES["int4" if int4 else "int8" if scaled else "fp"] += 1
    TILE_LAUNCHES["chunk" if chunk else "row"] += 1
    return out[:, 0] if squeeze else out


def paged_attention_decode(q, k_pages, v_pages, page_table, pos, *,
                           k_scale=None, v_scale=None, k_redist=None,
                           v_redist=None, window=None,
                           softcap: Optional[float] = None,
                           plan_kv_heads: Optional[int] = None):
    """Impl-dispatching entry point.  q [b, h, dh] (decode) or
    [b, sq, h, dh] (verify block / prefill chunk, ``pos`` the first row's
    position).  ``plan_kv_heads`` (default: the pages' own KV heads) is
    the head count the kernel's split plan is made for; the plain version
    does not split."""
    with accounting.site("paged_attention", lambda: _cost(
            q, page_table, k_pages, v_pages, k_scale, v_scale)):
        return _run(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                    k_redist, v_redist, window, softcap, plan_kv_heads)


def _run(q, k_pages, v_pages, page_table, pos, k_scale, v_scale, k_redist,
         v_redist, window, softcap, plan_kv_heads):
    if _PAGED_IMPL == "ref" or not q.is_cuda:
        return paged_attention_plain(
            q, k_pages, v_pages, page_table, pos, k_scale=k_scale,
            v_scale=v_scale, k_redist=k_redist, v_redist=v_redist,
            window=window, softcap=softcap)
    return _launch(q, k_pages, v_pages, page_table, pos, k_scale, v_scale,
                   k_redist, v_redist, window, softcap, plan_kv_heads)


def _cost(q, page_table, *pages):
    """``accounting.paged_cost`` from the shapes alone: every key of the
    table (its width x the page size), each page array's bytes a key."""
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    sq = 1 if q.dim() == 3 else q.shape[1]
    keys = page_table.shape[1] * pages[0].shape[1]
    per_key = sum(math.prod(t.shape[2:]) * t.element_size()
                  for t in pages if t is not None)
    return accounting.paged_cost(b, sq, h, dh, q.element_size(), keys,
                                 per_key)
